"""COCO json from the port's validator (`save_json`: `pred_to_json`,
`eval_json`, `coco80_to_coco91_class`) against the JAX package's, on the
CPU.

Limits, each with its reason:

* rows from the same detections: equal, `image_id`, `category_id` and the
  rounding of `bbox` (3 decimals) and `score` (5) included (the same
  float64 arithmetic and Python rounding);
* rows end to end (each validator's own detections): `image_id` and
  `category_id` equal, `bbox` within 2e-3 and `score` within 2e-5: the
  validator's limits on the detections (boxes 1e-3 px, scores 1e-5,
  `tests/test_torch_val.py`) plus one unit of each field's rounding.
"""
import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest

from mgdt_yolo_tpu.cfg import get_cfg
from mgdt_yolo_tpu.engine.validator import DetectionValidator as JaxValidator
from mgdt_yolo_tpu.engine.validator import coco80_to_coco91_class as jax_coco91
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS
from mgdt_yolo_tpu_torch.engine.trainer import Trainer
from mgdt_yolo_tpu_torch.engine.validator import DetectionValidator, coco80_to_coco91_class
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from test_torch_dataset import write_dataset, write_yaml
from test_torch_facade import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import NPZ, _nest, _npz

IMGSZ = 96
# val images renamed to COCO's numeric stems, and one named otherwise
VAL_SIZES = [(96, 96), (64, 96), (96, 72), (48, 80), (80, 64)]
STEMS = ["000000000139", "000000000285", "000000000632", "000000000724", "crate_07"]


def test_coco_class_map_matches_jax():
    assert coco80_to_coco91_class() == jax_coco91()
    assert len(set(coco80_to_coco91_class())) == 80


def _predn(rng, n, nc=80):
    xy = rng.uniform(0, 500, (n, 2))
    wh = rng.uniform(0.5, 200, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0.001, 1, (n, 1)),
                           rng.integers(0, nc, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("coco", [False, True], ids=["identity-map", "coco-91"])
def test_pred_to_json_rows_match_jax(coco):
    """The same detections give the same rows: numeric stems as int ids,
    other stems as strings, the category through the class map."""
    rng = np.random.default_rng(4 + coco)
    pv, jv = DetectionValidator(), JaxValidator(args=get_cfg())
    for v in (pv, jv):
        v.jdict = []
        v.class_map = coco80_to_coco91_class() if coco else list(range(1000))
    for stem in ("000000000139", "crate_07", "42"):
        predn = _predn(rng, int(rng.integers(0, 9)))
        pv.pred_to_json(predn, f"/data/images/val/{stem}.jpg")
        jv.pred_to_json(predn, f"/data/images/val/{stem}.jpg")
    assert pv.jdict == jv.jdict and len(pv.jdict) > 0
    assert {type(r["image_id"]) for r in pv.jdict} == {int, str}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("json")
    write_dataset(root, VAL_SIZES[:2], "train")
    write_dataset(root, VAL_SIZES, "val", seed=3)
    for i, stem in enumerate(STEMS):
        for d, ext in (("images", "png"), ("labels", "txt")):
            (root / d / "val" / f"im{i}.{ext}").rename(root / d / "val" / f"{stem}.{ext}")
    return write_yaml(root)


def _rows(path):
    return sorted(json.loads(Path(path).read_text()),
                  key=lambda r: (str(r["image_id"]), -r["score"], r["bbox"]))


def test_predictions_json_end_to_end_matches_jax(data, tmp_path):
    """`save_json=True`: predictions.json under `save_dir`, its rows JAX's
    within the validator's limits, and each row one of the validator's own
    detections in its image's pixels."""
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    args = {"data": str(data), "imgsz": IMGSZ, "batch": 4, "save_json": True}
    jv = JaxValidator(args=get_cfg(overrides={**args, "plots": False,
                                              "save_dir": str(tmp_path / "jax")}))
    want = jv(jm, jax.tree.map(np.asarray, _nest(_npz(NPZ))))
    pv = DetectionValidator({**args, "amp": False, "save_dir": tmp_path / "port"})
    got = pv(DetectionModel.from_npz(NPZ, device="cpu"))
    assert pv.pred_json == tmp_path / "port" / "predictions.json"
    g, w = _rows(pv.pred_json), _rows(tmp_path / "jax" / "predictions.json")
    assert len(g) == len(w) == sum(len(p) for p in pv.per_image_preds) > 0
    for a, b in zip(g, w):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=2e-3)
        assert abs(a["score"] - b["score"]) <= 2e-5
    assert {r["image_id"] for r in g} == {139, 285, 632, 724, "crate_07"}
    # every row is a detection of the validator's, xyxy -> top-left xywh
    for det, path in zip(pv.per_image_preds, pv.per_image_paths):
        stem = Path(path).stem
        mine = [r for r in g if str(r["image_id"]).zfill(12) == stem.zfill(12)]
        assert len(mine) == len(det)
        want_rows = sorted((round(float(x1), 3), round(float(y1), 3), round(float(s), 5))
                           for x1, y1, _, _, s, _ in det.tolist())
        assert sorted((r["bbox"][0], r["bbox"][1], r["score"]) for r in mine) == want_rows
    for k in ("precision", "recall", "map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_eval_json_without_pycocotools_warns_and_keeps_the_map(tmp_path, caplog):
    """A COCO split whose annotations exist: both write the same
    predictions.json, and without pycocotools the port warns, as JAX does,
    and keeps its own mAP."""
    (tmp_path / "annotations").mkdir()
    anno = tmp_path / "annotations" / "instances_val2017.json"
    anno.write_text(json.dumps({"images": [], "annotations": [], "categories": []}))
    rows = [{"image_id": 139, "category_id": 1, "bbox": [1.0, 2.0, 3.0, 4.0], "score": 0.5}]
    pv = DetectionValidator({"save_json": True, "save_dir": tmp_path / "port"})
    jv = JaxValidator(args=get_cfg(overrides={"save_json": True,
                                              "save_dir": str(tmp_path / "jax")}))
    results = {"map": 0.25, "map50": 0.5}
    for v in (pv, jv):
        v.is_coco, v.anno_json, v.jdict = True, anno, list(rows)
    with caplog.at_level(logging.WARNING):
        got = pv.eval_json(dict(results))
    want = jv.eval_json(dict(results))
    assert got == want == results
    assert "pycocotools" in caplog.text
    assert json.loads((tmp_path / "port" / "predictions.json").read_text()) == \
        json.loads((tmp_path / "jax" / "predictions.json").read_text()) == rows


def test_coco_split_is_sniffed_as_jax(tmp_path):
    """A `coco` ... `val2017` data string gets COCO's 91 category ids, and
    the annotations beside the image path's grandparent."""
    def loader(img_path):
        return type("L", (), {"dataset": type("D", (), {"img_path": str(img_path)})()})()

    pv = DetectionValidator({"data": "coco.yaml"})
    pv._coco_split(loader(tmp_path / "coco" / "images" / "val2017"))
    assert pv.is_coco and pv.class_map == jax_coco91()
    assert pv.anno_json == tmp_path / "coco" / "annotations" / "instances_val2017.json"
    pv = DetectionValidator({"data": "pigs.yaml"})
    pv._coco_split(loader(tmp_path / "pigs" / "images" / "val"))
    assert not pv.is_coco and pv.class_map == list(range(1000)) and pv.anno_json is None


def test_trainer_writes_predictions_json_with_the_run(data, tmp_path):
    """The trainer's validation honours `save_json`: predictions.json lands
    in its run directory, as JAX's trainer puts it there."""
    model = DetectionModel.from_npz(NPZ, device="cpu")
    tr = Trainer(model, overrides={"data": str(data), "imgsz": IMGSZ, "batch": 2,
                                   "epochs": 1, "save_json": True, "workers": 2},
                 save_dir=tmp_path / "run")
    assert tr.args["save_json"] is True and TRAIN_DEFAULTS["save_json"] is False
    tr.validate()
    rows = json.loads((tmp_path / "run" / "predictions.json").read_text())
    assert len(rows) == sum(len(p) for p in tr.validator.per_image_preds) > 0
