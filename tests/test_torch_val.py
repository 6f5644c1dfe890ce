"""The port's validation path against the JAX package's, on the CPU: the
metrics copy, the pad-only letterbox and validation collate, `scale_boxes`,
and the whole `DetectionValidator` stage by stage on the committed weights.

Tolerances, each with its reason:

* metrics, letterbox, collate and `scale_boxes`: exact (a copy of the same
  numpy arithmetic);
* the validator, float32, windowed DCN on both sides: per image the same
  number of detections and classes, boxes within 1e-3 px and scores within
  1e-5 (the model's raw maps agree to ~1e-5, `tests/test_torch_model.py`),
  then the same TP matrix, and precision, recall, mAP50, mAP50-95 and
  fitness within 1e-6 (the same matches through the same numpy code; only
  the confidences' last bits can move the precision curve's
  interpolation).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgdt_yolo_tpu.cfg import get_cfg
from mgdt_yolo_tpu.data.augment import letterbox as jax_letterbox
from mgdt_yolo_tpu.data.build import collate as jax_collate
from mgdt_yolo_tpu.data.dataset import SyntheticDetectionDataset as JaxSynthetic
from mgdt_yolo_tpu.engine.validator import DetectionValidator as JaxValidator
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.ops.boxes import clip_boxes as jax_clip_boxes
from mgdt_yolo_tpu.ops.boxes import scale_boxes as jax_scale_boxes
from mgdt_yolo_tpu.utils import metrics as JM
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, letterbox
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset, val_dataset
from mgdt_yolo_tpu_torch.engine.validator import DetectionValidator
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.ops.boxes import clip_boxes, scale_boxes
from mgdt_yolo_tpu_torch.utils import metrics as PM

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "weights" / "mgdt_n_synth.npz"
IMGSZ = 64


# ---------------------------------------------------------------------------
# the metrics copy
# ---------------------------------------------------------------------------

def _det_inputs(rng, n_img=6, nc=3):
    """Per image: detections (n, 6) and labels, boxes jittered around the
    labels so that matches happen at several IoU thresholds."""
    dets, gts = [], []
    for _ in range(n_img):
        m = int(rng.integers(0, 6))
        xy = rng.uniform(0, 80, (m, 2))
        g = np.concatenate([xy, xy + rng.uniform(8, 40, (m, 2))], 1).astype(np.float32)
        gc = rng.integers(0, nc, m).astype(float)
        n = int(rng.integers(0, 9))
        src = g[rng.integers(0, max(m, 1), n)] if m else rng.uniform(0, 100, (n, 4))
        b = (src + rng.normal(0, 3, (n, 4))).astype(np.float32)
        b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] + 1)
        d = np.concatenate([b, rng.uniform(0.001, 1, (n, 1)),
                            rng.integers(0, nc, (n, 1))], 1).astype(np.float32)
        dets.append(d)
        gts.append((g.reshape(-1, 4), gc))
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_copy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    dets, gts = _det_inputs(rng)
    iouv = np.linspace(0.5, 0.95, 10)
    pm, jm = PM.DetMetrics(), JM.DetMetrics()
    pc, jc = PM.ConfusionMatrix(3), JM.ConfusionMatrix(3)
    for d, (g, gc) in zip(dets, gts):
        tp = PM.match_predictions(d[:, :4], d[:, 5], g, gc, iouv)
        np.testing.assert_array_equal(tp, JM.match_predictions(d[:, :4], d[:, 5], g, gc, iouv))
        np.testing.assert_array_equal(PM.box_iou_numpy(g, d[:, :4]),
                                      JM.box_iou_numpy(g, d[:, :4]))
        pm.update(tp, d[:, 4], d[:, 5], gc)
        jm.update(tp, d[:, 4], d[:, 5], gc)
        pc.process_batch(d, g, gc)
        jc.process_batch(d, g, gc)
    assert pm.process() == jm.process()
    assert pm.fitness == jm.fitness == PM.fitness(pm.results) == JM.fitness(jm.results)
    for k in ("precision", "recall", "ap", "nt", "classes"):
        np.testing.assert_array_equal(pm.per_class[k], jm.per_class[k], err_msg=k)
    np.testing.assert_array_equal(pc.matrix, jc.matrix)
    assert PM.counting_agreement(dets, gts, [0, 1, 2]) == \
        JM.counting_agreement(dets, gts, [0, 1, 2])
    counts = [{int(c): int((d[:, 5] == c).sum()) for c in range(3)} for d in dets]
    truth = [{int(c): int((gc == c).sum()) for c in range(3)} for _, gc in gts]
    assert PM.counting_errors(counts, truth, [0, 1, 2]) == \
        JM.counting_errors(counts, truth, [0, 1, 2])
    rec, prec = np.sort(rng.uniform(0, 1, 20)), rng.uniform(0, 1, 20)
    assert PM.compute_ap(rec, prec)[0] == JM.compute_ap(rec, prec)[0]


# ---------------------------------------------------------------------------
# letterbox, validation collate and scale_boxes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(48, 48), (40, 64), (64, 37), (64, 64), (33, 50)])
def test_pad_only_letterbox_and_scale_boxes_match_jax(hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, want = letterbox(img, (IMGSZ, IMGSZ)), jax_letterbox(img, (IMGSZ, IMGSZ),
                                                             scaleup=False)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    boxes = np.concatenate([rng.uniform(-5, 70, (7, 4)), rng.uniform(0, 1, (7, 2))],
                           1).astype(np.float32)
    for ratio_pad in (None, (got[1], got[2])):
        want_b = jax_scale_boxes((IMGSZ, IMGSZ), boxes, hw, ratio_pad)
        np.testing.assert_array_equal(scale_boxes((IMGSZ, IMGSZ), boxes, hw, ratio_pad), want_b)
    np.testing.assert_array_equal(clip_boxes(boxes[:, :4], hw),
                                  np.asarray(jax_clip_boxes(jnp.asarray(boxes[:, :4]), hw)))


def test_validation_collate_and_loader_match_jax():
    ours, theirs = SyntheticDetectionDataset(n=5, imgsz=48, seed=3), JaxSynthetic(
        n=5, imgsz=48, seed=3)
    items = [ours[i] for i in range(5)]
    got = collate(items, IMGSZ, 8, train=False)
    want = jax_collate([theirs[i] for i in range(5)], IMGSZ, 8, train=False)
    for k in ("img", "gt_labels", "gt_bboxes", "mask_gt"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(got["metas"], want["metas"]):
        assert tuple(a["ori_shape"]) == tuple(b["ori_shape"]) and a["ratio_pad"] == b["ratio_pad"]
    loader = DataLoader(ours, 2, IMGSZ, train=False)
    batches = list(loader)
    assert len(loader) == len(batches) == 3 and len(batches[-1]["img"]) == 1
    assert loader.max_gt == 8 and not loader.device_augment
    np.testing.assert_array_equal(np.concatenate([b["img"] for b in batches]), got["img"])
    # an item larger than the square is shrunk (cv2's INTER_LINEAR) since the
    # from-disk path, as JAX's collate shrinks it; a 2x down-ratio is exact
    big = {"img": SyntheticDetectionDataset(n=1, imgsz=2 * IMGSZ, seed=3)[0]["img"],
           "boxes": np.asarray([[10, 20, 60, 90]], np.float32), "cls": np.ones(1, np.float32)}
    got_lb, want_lb = letterbox(big["img"], (IMGSZ, IMGSZ)), jax_letterbox(
        big["img"], (IMGSZ, IMGSZ), scaleup=False)
    np.testing.assert_array_equal(got_lb[0], want_lb[0])
    assert got_lb[1:] == want_lb[1:] and got_lb[1] == (0.5, 0.5)
    got, want = collate([big], IMGSZ, 8, train=False), jax_collate([big], IMGSZ, 8, train=False)
    for k in ("img", "gt_labels", "gt_bboxes", "mask_gt"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_val_dataset_is_the_jax_trainers():
    ds = val_dataset(640, nc=2, seed=4)
    assert (len(ds), ds.imgsz, ds.seed) == (16, 320, 5)
    assert val_dataset(64).imgsz == 64


# ---------------------------------------------------------------------------
# the validator, stage by stage
# ---------------------------------------------------------------------------

def _nest(path):
    tree = {}
    with np.load(str(path)) as f:
        for key in f.files:
            *p, leaf = key.split(".")
            node = tree
            for q in p:
                node = node.setdefault(q, {})
            node[leaf] = jnp.asarray(f[key])
    return tree


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    return jm, _nest(NPZ)


# (name, scenes, scene size, input size): the JAX trainer's synthetic
# validation set at 64 px (no true positives: the weights were trained on
# 320 px scenes), and 96 px scenes letterboxed to 128 px, where the model
# finds objects (mAP50 ~0.26) and `scale_boxes` maps boxes back
VAL_CASES = [("val-set", 16, 64, 64), ("padded", 8, 96, 128)]


@pytest.mark.parametrize("case", VAL_CASES, ids=[c[0] for c in VAL_CASES])
def test_validator_matches_jax(case, jax_model):
    name, n, size, imgsz = case
    jm, variables = jax_model
    args = {"imgsz": imgsz, "batch": 8}
    jv = JaxValidator(args=get_cfg(overrides={**args, "plots": False}))
    want = jv(jm, variables, dataset=JaxSynthetic(n=n, imgsz=size, seed=1))
    ds = SyntheticDetectionDataset(n=n, imgsz=size, seed=1)
    if name == "val-set":
        ds = val_dataset(IMGSZ, seed=0)
    pv = DetectionValidator({**args, "amp": False})
    got = pv(DetectionModel.from_npz(NPZ, device="cpu"), DataLoader(ds, 8, imgsz, train=False))
    assert len(pv.per_image_preds) == len(jv._per_image_preds) == n
    total = 0
    for a, b in zip(pv.per_image_preds, jv._per_image_preds):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 5], b[:, 5])
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-5)
        total += len(a)
    for (ga, ca), (gb, cb) in zip(pv.per_image_gts, jv._per_image_gts):
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(ca, cb)
    for a, b in zip(pv.metrics._tp, jv.metrics._tp):
        np.testing.assert_array_equal(a, b)
    for k in ("precision", "recall", "map50", "map", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert pv.counting_stats == jv.counting_stats
    np.testing.assert_array_equal(pv.confusion_matrix.matrix, jv.confusion_matrix.matrix)
    assert total > 0
    if name == "padded":
        assert sum(int(t.any()) for t in pv.metrics._tp) > 0 and got["map50"] > 0.1
    print(f"{name}: {total} detections, " +
          ", ".join(f"{k} {got[k]:.6f}" for k in ("precision", "recall", "map50", "map")))
