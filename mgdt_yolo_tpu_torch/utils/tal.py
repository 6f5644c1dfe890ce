"""Task-aligned label assignment over padded targets, the counterpart of
`mgdt_yolo_tpu/utils/tal.py` (the fork's `HeuristicPositiveSampleAssigner_v1`).

The fork's two changes to upstream TAL are kept: the classification exponent
anneals as `alpha = 0.5 * (100 - step // 161) / 100`, with the per-batch
counter `step` passed in, and an anchor claimed by several boxes goes to the
box of the highest align metric (not the highest overlap). Empty images
degenerate to zero masks. Top-k ties resolve as `lax.top_k` resolves them,
lower anchor index first, through a stable descending sort.

Everything here runs without gradient: its inputs are detached predictions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor   # (b, A) int64
    target_bboxes: torch.Tensor   # (b, A, 4) xyxy, units of the gt boxes
    target_scores: torch.Tensor   # (b, A, nc) float32
    fg_mask: torch.Tensor         # (b, A) bool
    target_gt_idx: torch.Tensor   # (b, A) int64


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """Anchors whose centre lies strictly inside each gt box -> (b, G, A)."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:]
    deltas = torch.cat([xy_centers[None, None] - lt, rb - xy_centers[None, None]],
                       dim=-1)
    return (deltas.amin(dim=-1) > eps).to(gt_bboxes.dtype)


def select_highest_overlaps(mask_pos: torch.Tensor, metric: torch.Tensor,
                            n_max_boxes: int):
    """Keep, for an anchor claimed by several gts, the highest-metric gt.
    Returns (target_gt_idx (b, A), fg_mask (b, A), mask_pos (b, G, A))."""
    fg_mask = mask_pos.sum(dim=-2)
    mask_multi = fg_mask[:, None, :] > 1
    max_idx = metric.argmax(dim=-2)     # first maximum, as jnp.argmax
    is_max = (max_idx[:, None, :] == torch.arange(
        n_max_boxes, device=metric.device)[None, :, None]).to(mask_pos.dtype)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    return mask_pos.argmax(dim=-2), mask_pos.sum(dim=-2), mask_pos


def _select_topk_candidates(metrics: torch.Tensor, topk: int,
                            topk_mask: torch.Tensor) -> torch.Tensor:
    """Scatter-count each gt's top-k anchors (masked rows count anchor 0)
    and zero the anchors counted more than once."""
    idxs = torch.sort(metrics, dim=-1, descending=True, stable=True).indices[..., :topk]
    idxs = torch.where(topk_mask, idxs, 0)
    count = torch.zeros(metrics.shape, dtype=torch.int32, device=metrics.device)
    count.scatter_add_(-1, idxs, torch.ones_like(idxs, dtype=torch.int32))
    count = torch.where(count > 1, 0, count)
    return count.to(metrics.dtype)


@torch.no_grad()
def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                        mask_gt, alpha, num_classes: int, topk: int = 10,
                        beta_static: float = 8.0, eps: float = 1e-9) -> AssignResult:
    """Task-aligned assignment.

    pd_scores (b, A, nc) sigmoid scores; pd_bboxes (b, A, 4) xyxy pixels;
    anc_points (A, 2) pixels; gt_labels (b, G) int; gt_bboxes (b, G, 4) xyxy
    (zeros in padding rows); mask_gt (b, G) bool; alpha a float32 scalar.
    """
    b, A, nc = pd_scores.shape
    G = gt_bboxes.shape[1]
    mask_gt_f = mask_gt.to(pd_scores.dtype)

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
    valid = mask_in_gts * mask_gt_f[..., None]
    labels = gt_labels.long()
    bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                               labels[..., None].expand(b, G, A)) * valid
    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :],
                        xywh=False, CIoU=True).squeeze(-1)
    overlaps = overlaps.clamp(min=0) * valid
    align_metric = bbox_scores ** alpha * overlaps ** beta_static

    topk_mask = mask_gt[..., None].expand(b, G, topk)
    mask_topk = _select_topk_candidates(align_metric, topk, topk_mask)
    mask_pos = mask_topk * mask_in_gts * mask_gt_f[..., None]
    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, align_metric, G)

    target_labels = torch.gather(labels, 1, target_gt_idx)
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, A, 4))
    fg = fg_mask > 0
    target_scores = F.one_hot(target_labels, num_classes).to(pd_scores.dtype)
    target_scores = torch.where(fg[..., None], target_scores, 0.0)

    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(dim=-1, keepdim=True)
    pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm = (align_metric * pos_overlaps / (pos_align + eps)).amax(dim=-2)
    return AssignResult(target_labels, target_bboxes, target_scores * norm[..., None],
                        fg, target_gt_idx)


def heuristic_assign_v1(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                        mask_gt, step: int, num_classes: int, epoch_num: int = 161,
                        max_epochs: int = 100, topk: int = 10,
                        beta: float = 8.0) -> AssignResult:
    """The fork's assigner: TAL with alpha annealed by `step // epoch_num`,
    computed in float32 as the JAX package computes it."""
    coff = torch.tensor(int(step) // epoch_num, dtype=torch.float32)
    alpha = (0.5 * (max_epochs - coff) / max_epochs).to(pd_scores.device)
    return task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels,
                               gt_bboxes, mask_gt, alpha, num_classes=num_classes,
                               topk=topk, beta_static=beta)
