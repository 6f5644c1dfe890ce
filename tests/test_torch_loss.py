"""The port's box geometry, assigner and detection loss against the JAX
package, in float32 on the CPU, on inputs made with numpy from a seed.

Tolerances: CIoU values and gradients 1e-6 (elementwise float32 arithmetic
in the same order, up to XLA's fusions); the assigner's masks, gt indices,
labels and boxes exactly, its scores 1e-6; loss parts and total 1e-5 of
their value and the gradient with respect to the raw maps 1e-6 absolute
(sums over ~100 anchors in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.ops.boxes import bbox2dist as jax_bbox2dist
from mgdt_yolo_tpu.ops.boxes import bbox_iou as jax_bbox_iou
from mgdt_yolo_tpu.utils.loss import DetectionLoss as JaxDetectionLoss
from mgdt_yolo_tpu.utils.loss import pad_targets as jax_pad_targets
from mgdt_yolo_tpu.utils.tal import heuristic_assign_v1 as jax_assign
from mgdt_yolo_tpu_torch.ops.boxes import bbox2dist, bbox_iou
from mgdt_yolo_tpu_torch.utils.loss import DetectionLoss, pad_targets
from mgdt_yolo_tpu_torch.utils.tal import heuristic_assign_v1

STEPS = [0, 161 * 50]


def _boxes(rng, n, lo=0.0, hi=64.0, min_wh=0.5, max_wh=30.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_bbox_iou_ciou_matches_jax():
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 200), _boxes(rng, 200)
    b2[:20] = b1[:20]                     # identical pairs (IoU 1)
    b2[20:40, :2] += 100.0                # disjoint pairs
    b2[20:40, 2:] += 100.0
    cot = rng.standard_normal((200, 1)).astype(np.float32)

    def f(a, b):
        return jnp.sum(jax_bbox_iou(a, b, xywh=False, CIoU=True) * cot)
    want = np.asarray(jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=False, CIoU=True))
    want_g = jax.grad(f, argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1, t2 = (torch.from_numpy(b).requires_grad_() for b in (b1, b2))
    got = bbox_iou(t1, t2, xywh=False, CIoU=True)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    for t, w in zip((t1, t2), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    iou = bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=False)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jax_bbox_iou(
        jnp.asarray(b1), jnp.asarray(b2), xywh=False)), rtol=0, atol=1e-6)


def test_bbox2dist_matches_jax():
    rng = np.random.default_rng(1)
    anchors = rng.uniform(0, 8, (64, 2)).astype(np.float32)
    boxes = _boxes(rng, 64, hi=8.0, max_wh=40.0)
    want = np.asarray(jax_bbox2dist(jnp.asarray(anchors), jnp.asarray(boxes), 15))
    got = bbox2dist(torch.from_numpy(anchors), torch.from_numpy(boxes), 15).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == np.float32(15 - 0.01)


def _assign_inputs(seed=2):
    """Three images on an 8x8 grid of stride 8 (A = 64): boxes of every
    size with overlaps; small boxes whose anchors all score 0 (the top-k
    ties); an image of padding only."""
    rng = np.random.default_rng(seed)
    b, A, nc, G = 3, 64, 2, 8
    gx, gy = np.meshgrid(np.arange(8) + 0.5, np.arange(8) + 0.5)
    anc = (np.stack([gx, gy], -1).reshape(-1, 2) * 8).astype(np.float32)
    scores = rng.uniform(0, 1, (b, A, nc)).astype(np.float32)
    scores[0, rng.uniform(size=A) < 0.4] = 0.0           # many exact-zero scores
    scores[2] = np.round(scores[2] * 4) / 4               # few distinct values
    scores[2, :40] = 0.0
    pboxes = np.concatenate([anc - rng.uniform(2, 30, (A, 2)),
                             anc + rng.uniform(2, 30, (A, 2))], -1)
    pboxes = np.broadcast_to(pboxes, (b, A, 4)).astype(np.float32).copy()
    pboxes[1:] += rng.uniform(-3, 3, (2, A, 4)).astype(np.float32)
    gt_boxes = np.zeros((b, G, 4), np.float32)
    gt_labels = np.zeros((b, G), np.int32)
    mask = np.zeros((b, G), bool)
    gt_boxes[0, :5] = [[2, 2, 60, 60], [4, 4, 36, 36], [30, 30, 50, 62],
                       [9, 9, 23, 15], [40, 2, 44, 14]]      # nested, overlapping, thin
    gt_labels[0, :5] = [0, 1, 1, 0, 1]
    mask[0, :5] = True
    gt_boxes[2, :3] = [[1, 1, 13, 13], [33, 1, 47, 22], [0, 40, 30, 63]]  # small, all-zero scores
    gt_labels[2, :3] = [1, 0, 1]
    mask[2, :3] = True
    return scores, pboxes, anc, gt_labels, gt_boxes, mask


@pytest.mark.parametrize("step", STEPS)
def test_assigner_matches_jax(step):
    args = _assign_inputs()
    want = jax_assign(*[jnp.asarray(a) for a in args], step, num_classes=2)
    got = heuristic_assign_v1(*[torch.from_numpy(a) for a in args], step, num_classes=2)
    fg = np.asarray(want.fg_mask)
    assert fg[0].sum() > 5 and fg[1].sum() == 0 and fg[2].sum() > 0
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(want.target_labels))
    np.testing.assert_array_equal(got.target_bboxes.numpy(), np.asarray(want.target_bboxes))
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               rtol=0, atol=1e-6)


def test_assigner_anneal_changes_scores():
    args = [torch.from_numpy(a) for a in _assign_inputs()]
    s0 = heuristic_assign_v1(*args, 0, num_classes=2).target_scores
    s1 = heuristic_assign_v1(*args, 161 * 50, num_classes=2).target_scores
    assert not torch.equal(s0, s1)


def _labels():
    """Flat normalised labels of two images: three boxes in the first, two
    in the second."""
    idx = np.array([0, 0, 0, 1, 1])
    cls = np.array([0, 1, 1, 0, 1], np.float32)
    xywhn = np.array([[0.5, 0.5, 0.6, 0.5], [0.3, 0.3, 0.2, 0.3], [0.7, 0.6, 0.1, 0.1],
                      [0.25, 0.75, 0.4, 0.3], [0.6, 0.4, 0.5, 0.5]], np.float32)
    return idx, cls, xywhn


@pytest.mark.parametrize("batch_size, max_gt", [(2, 8), (2, 2), (3, 4)])
def test_pad_targets_matches_jax(batch_size, max_gt):
    """Room for every box, fewer slots than boxes, and an image with none."""
    args = (*_labels(), batch_size, max_gt, (64, 96))
    for a, b in zip(pad_targets(*args), jax_pad_targets(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _loss_inputs(seed=4):
    """Raw maps (2, 8, 8, 66) of the flagship's head (nc 2, reg_max 16,
    stride 8) and padded targets from normalised labels."""
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((2, 8, 8, 66)) * 2).astype(np.float32)
    targets = pad_targets(*_labels(), 2, 8, (64, 64))
    keys = ("gt_labels", "gt_bboxes", "mask_gt")
    return feats, dict(zip(keys, targets))


@pytest.mark.parametrize("step", STEPS)
def test_detection_loss_matches_jax(step):
    feats, batch = _loss_inputs()
    jl = JaxDetectionLoss(2, 16, (8,))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(f):
        return jl([f], jb, step).total
    want = jl([jnp.asarray(feats)], jb, step)
    want_grad = np.asarray(jax.grad(total)(jnp.asarray(feats)))

    tf = torch.from_numpy(feats).requires_grad_()
    got = DetectionLoss(2, 16, (8,))([tf], {k: torch.from_numpy(v) for k, v in batch.items()},
                                     step)
    got.total.backward()
    assert not got.parts.requires_grad
    np.testing.assert_allclose(got.parts.numpy(), np.asarray(want.parts), rtol=1e-5)
    np.testing.assert_allclose(got.total.item(), float(want.total), rtol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), want_grad, rtol=0, atol=1e-6)
    assert np.abs(want_grad).max() > 1e-3
