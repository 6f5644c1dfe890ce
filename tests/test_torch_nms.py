"""The port's batched NMS against the JAX package: same detections, counts,
source anchors and survivor order (CPU, float32).

Inputs: the JAX flagship's decoded output on synthetic scenes at 320 px (the
committed weights' training size), and a synthetic pool whose scores take
only 20 distinct values, so exact ties are everywhere and the top-k tie
order decides the result; and clusters of near-identical boxes of different
classes with two channels past the class scores, for `agnostic` and `nc`.
Both sides compute the same IoUs with the same
float32 operations, so everything is held to exact equality.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from mgdt_yolo_tpu_torch.data.synthetic import synthetic_batch
from mgdt_yolo_tpu_torch.ops.nms import non_max_suppression
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NPZ = Path(__file__).resolve().parents[1] / "weights" / "mgdt_n_synth.npz"


@pytest.fixture(scope="module")
def decoded():
    """(2, 6, 1600) decoded flagship output on two synthetic scenes."""
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    variables = {}
    with np.load(str(NPZ)) as flat:
        for key in flat.files:
            *path, leaf = key.split(".")
            node = variables
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    jm.set_deform_semantics("windowed")
    x = synthetic_batch(2, imgsz=320).astype(np.float32) / 255.0
    out, _ = jax.jit(lambda v, x: jm.model.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return np.array(out)


def _tied_pool(B=2, A=3000, nc=3, seed=0):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 320, (B, A, 2))
    wh = rng.uniform(8, 80, (B, A, 2))
    scores = rng.integers(0, 20, (B, A, nc)) / 20.0
    return np.concatenate([cxy, wh, scores], -1).astype(np.float32).transpose(0, 2, 1)


def _both(pred, **kw):
    want = jax_nms(jnp.asarray(pred), return_idx=True, **kw)
    got = non_max_suppression(torch.from_numpy(pred), return_idx=True, **kw)
    for w, g, name in zip(want, got, ("det", "counts", "idx")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got


@pytest.mark.parametrize("block", [256, 0])
@pytest.mark.parametrize("conf", [0.25, 0.001])
def test_matches_jax_on_model_output(decoded, block, conf):
    det, counts, _ = _both(decoded, conf_thres=conf, iou_thres=0.7, max_det=300,
                           pre_topk=1024, block=block)
    assert det.shape == (2, 300, 6) and (counts > 0).all()


@pytest.mark.parametrize("block", [256, 0])
@pytest.mark.parametrize("multi_label", [False, True])
def test_matches_jax_with_score_ties(block, multi_label):
    pred = _tied_pool()
    _, counts, _ = _both(pred, conf_thres=0.25, iou_thres=0.5, max_det=300,
                         pre_topk=1024, multi_label=multi_label, block=block)
    assert (counts > 0).all()


def test_fewer_candidates_than_rows_pad():
    pred = _tied_pool(A=100, nc=1)
    det, counts, idx = _both(pred, conf_thres=0.25, iou_thres=0.5, max_det=300,
                             pre_topk=1024, block=256)
    assert det.shape == (2, 300, 6)
    assert (idx[:, counts.max():] == -1).all()


def _overlapping_classes(B=2, clusters=150, per=4, nc=3, extra=2, seed=1):
    """Clusters of near-identical boxes whose members have different best
    classes, then `extra` channels past the class scores (as a segment or
    pose head appends) with scores above every class's."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(40, 600, (B, clusters, 1, 2))
    size = rng.uniform(20, 120, (B, clusters, 1, 2))
    cxy = (centre + rng.normal(0, 2, (B, clusters, per, 2))).reshape(B, -1, 2)
    wh = (size * rng.uniform(0.95, 1.05, (B, clusters, per, 2))).reshape(B, -1, 2)
    scores = rng.uniform(0, 0.2, (B, clusters * per, nc))
    best = rng.integers(0, nc, (B, clusters * per))
    np.put_along_axis(scores, best[..., None], rng.uniform(0.3, 1.0, (B, clusters * per, 1)),
                      axis=-1)
    tail = rng.uniform(1.0, 2.0, (B, clusters * per, extra))
    return np.concatenate([cxy, wh, scores, tail], -1).astype(np.float32).transpose(0, 2, 1)


@pytest.mark.parametrize("block", [256, 0])
@pytest.mark.parametrize("multi_label", [False, True])
def test_agnostic_and_nc_match_jax(block, multi_label):
    """`agnostic` and `nc` as JAX's: exact detections, counts and anchors;
    across classes more boxes are suppressed; `nc` reads only its scores."""
    pred = _overlapping_classes()
    kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=300, pre_topk=1024,
              multi_label=multi_label, block=block, nc=3)
    _, per_class, _ = _both(pred, agnostic=False, **kw)
    _, agnostic, _ = _both(pred, agnostic=True, **kw)
    assert (agnostic < per_class).all() and (agnostic > 0).all()
    # without nc the two extra channels are read as classes, and win
    det, _, _ = _both(pred, agnostic=False, **{**kw, "nc": None})
    assert set(det[..., 5].unique().tolist()) <= {0.0, 3.0, 4.0} and (det[..., 5] >= 3).any()
