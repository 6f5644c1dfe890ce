"""Rectangular validation in the port (`data/build.py`'s rect plan, the
validator's `rect`) against the JAX package's, on the CPU, on a PNG
dataset whose images are ordered into landscape, square and portrait
batches.

Limits, each with its reason:

* the batch order, `batch_shapes` and the letterboxed batches: exact (the
  same arithmetic; every image fits its batch's shape, so the letterbox
  only pads, which both sides do bit for bit);
* the flagship's raw maps at a non-square input whose maps are odd and
  non-square down the whole graph (168x232: 21x29 at stride 8, 11x15,
  6x8): 1e-4, windowed and exact, as at square inputs
  (`tests/test_torch_model.py`);
* the validator under `rect=True`: the validator's limits
  (`tests/test_torch_val.py`): per image the same detections and classes,
  boxes 1e-3 px, scores 1e-5, the TP matrix exact, metrics 1e-6.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.cfg import get_cfg
from mgdt_yolo_tpu.data.build import DataLoader as JaxDataLoader
from mgdt_yolo_tpu.data.dataset import YOLODataset as JaxYOLODataset
from mgdt_yolo_tpu.engine.validator import DetectionValidator as JaxValidator
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu_torch.data.build import DataLoader
from mgdt_yolo_tpu_torch.data.dataset import YOLODataset
from mgdt_yolo_tpu_torch.engine.validator import DetectionValidator
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from test_torch_dataset import write_dataset, write_yaml
from test_torch_facade import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train import NPZ, _nest, _npz

IMGSZ, STRIDE, BATCH = 128, 8, 2
# (h, w): two landscape batches, one square and one portrait, each image
# within its batch's shape (so the letterbox pads only)
RECT_SIZES = [(96, 128), (72, 128), (128, 96), (128, 72), (96, 96), (100, 80), (64, 128),
              (120, 128)]
# the batch shapes JAX plans for them at 128 px, stride 8, pad 0.5
WANT_SHAPES = [[80, 136], [128, 136], [136, 136], [136, 104]]
ODD_INPUT = (168, 232)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("rect")
    write_dataset(root, RECT_SIZES[:2], "train")
    write_dataset(root, RECT_SIZES, "val", seed=7)
    return root, write_yaml(root)


@pytest.fixture(scope="module")
def flagship():
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    return jm, jax.tree.map(np.asarray, _nest(_npz(NPZ)))


def test_rect_plan_and_batches_match_jax(data):
    """The aspect order, the batch shapes and every letterboxed batch
    (pixels, labels, metas) equal JAX's DataLoader's."""
    root, _ = data
    img_dir = str(root / "images" / "val")
    ours = DataLoader(YOLODataset(img_dir), BATCH, IMGSZ, train=False, rect=True, stride=STRIDE)
    theirs = JaxDataLoader(JaxYOLODataset(img_dir, imgsz=IMGSZ), BATCH, IMGSZ, train=False,
                           rect=True, stride=STRIDE)
    assert ours._rect_order == theirs._rect_order
    np.testing.assert_array_equal(ours.batch_shapes, theirs.batch_shapes)
    assert ours.batch_shapes.tolist() == WANT_SHAPES
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(WANT_SHAPES)
    for g, w, shape in zip(got, want, WANT_SHAPES):
        assert g["img"].shape[1:3] == tuple(shape)
        for k in ("img", "gt_labels", "gt_bboxes", "mask_gt"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for mg, mw in zip(g["metas"], w["metas"]):
            assert mg["path"] == mw["path"] and tuple(mg["ori_shape"]) == tuple(mw["ori_shape"])
            assert mg["ratio_pad"] == mw["ratio_pad"]
    # a square loader of the same split is unchanged by the plan
    square = DataLoader(YOLODataset(img_dir), BATCH, IMGSZ, train=False)
    assert square.batch_shapes is None and next(iter(square))["img"].shape[1:3] == (128, 128)


@pytest.mark.parametrize("sem", ["windowed", "exact"])
def test_flagship_raw_maps_at_an_odd_rectangle(flagship, sem):
    """168x232: odd, non-square maps through the backbone, the GD neck's
    pools and resizes, the head's anchors and K1's plain version."""
    jm, variables = flagship
    jm.set_deform_semantics(sem)
    x = np.random.default_rng(9).uniform(0, 1, (1, *ODD_INPUT, 3)).astype(np.float32)
    want_dec, want = jax.jit(lambda v, a: jm.model.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    model = DetectionModel.from_npz(NPZ, device="cpu").set_deform_semantics(sem)
    with torch.no_grad():
        dec, got = model(torch.from_numpy(x))
    assert got[0].shape == (1, 21, 29, 4 * model.reg_max + model.nc)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want_dec), rtol=0, atol=5e-4)


def test_rect_validator_matches_jax(data, flagship):
    """`rect=True` on the YAML's val split: the same per-image detections,
    labels, TP matrix and metrics as JAX's validator, batch by batch at the
    planned shapes."""
    _, y = data
    jm, variables = flagship
    jm.set_deform_semantics("windowed")
    args = {"data": str(y), "imgsz": IMGSZ, "batch": BATCH, "rect": True}
    jv = JaxValidator(args=get_cfg(overrides={**args, "plots": False}))
    want = jv(jm, variables)
    pv = DetectionValidator({**args, "amp": False})
    got = pv(DetectionModel.from_npz(NPZ, device="cpu"))
    assert [list(s) for s in pv.batch_shapes] == WANT_SHAPES
    assert len(pv.per_image_preds) == len(jv._per_image_preds) == len(RECT_SIZES)
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
    assert total > 0
    print(f"rect: {total} detections, shapes {pv.batch_shapes}, " +
          ", ".join(f"{k} {got[k]:.6f}" for k in ("precision", "recall", "map50", "map")))


def test_trainer_validates_in_rect_batches(data):
    """The trainer honours `rect` for its validation loader (the model's
    stride), as JAX's validator does inside its trainer."""
    from mgdt_yolo_tpu_torch.engine.trainer import build_loader
    from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS
    _, y = data
    model = DetectionModel.from_npz(NPZ, device="cpu")
    a = {**TRAIN_DEFAULTS, "data": str(y), "imgsz": IMGSZ, "batch": BATCH, "rect": True}
    val, train = build_loader(a, False, model), build_loader(a, True, model)
    assert val.rect and val.batch_shapes.tolist() == WANT_SHAPES
    assert not train.rect and train.batch_shapes is None
