"""Detection training loss: BCE classification + CIoU box + DFL against
task-aligned targets, the counterpart of `mgdt_yolo_tpu/utils/loss.py`.

Targets arrive padded to (b, max_gt) (`pad_targets`, or `data/build.collate`),
so foreground selection is mask arithmetic. The loss is computed in float32
from raw maps of any type, and should be called outside autocast.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.build import pad_boxes
from ..ops.boxes import bbox2dist, bbox_iou, dist2bbox, make_anchors
from .tal import heuristic_assign_v1


class LossOutputs(NamedTuple):
    total: torch.Tensor   # scalar: parts.sum() * batch size
    parts: torch.Tensor   # (3,) detached box / cls / dfl, gains applied


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in float32."""
    logits = logits.float()
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Two-sided distribution focal loss, gather-free: cross-entropy against
    the interpolation weights max(0, 1 - |t - k|) over the bins (only the
    bins either side of t are non-zero). pred_dist (..., 4, bins) logits,
    target (..., 4) in [0, bins - 1). Returns (...,), the mean over sides."""
    bins = pred_dist.shape[-1]
    logp = F.log_softmax(pred_dist.float(), dim=-1)
    k = torch.arange(bins, dtype=torch.float32, device=pred_dist.device)
    w = (1.0 - (target[..., None].float() - k).abs()).clamp(min=0.0)
    return -(w * logp).sum(dim=-1).mean(dim=-1)


class DetectionLoss:
    """The detection loss with the JAX package's gains and assigner settings.
    `step` (the per-batch counter driving the assigner's anneal) is passed
    in explicitly."""

    def __init__(self, nc: int, reg_max: int, strides: Sequence[int],
                 box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
                 tal_topk: int = 10, tal_beta: float = 8.0, epoch_num: int = 161):
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.no = nc + reg_max * 4
        self.gains = (box_gain, cls_gain, dfl_gain)
        self.tal_topk, self.tal_beta, self.epoch_num = tal_topk, tal_beta, epoch_num

    def __call__(self, feats: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
                 step: int) -> LossOutputs:
        """feats: raw NHWC maps [(b, h, w, no)]; batch: gt_labels (b, G),
        gt_bboxes (b, G, 4) xyxy input pixels, mask_gt (b, G) bool."""
        c = self.detection_core(feats, batch, step)
        bg, cg, dg = self.gains
        parts = torch.stack([c["loss_box"] * bg, c["loss_cls"] * cg, c["loss_dfl"] * dg])
        return LossOutputs(parts.sum() * c["b"], parts.detach())

    def detection_core(self, feats, batch: Dict, step: int) -> Dict:
        b = feats[0].shape[0]
        rm = self.reg_max
        flat = torch.cat([f.float().reshape(b, -1, self.no) for f in feats], dim=1)
        pred_distri, pred_scores = flat[..., :rm * 4], flat[..., rm * 4:]
        anchor_points, stride_t = make_anchors([f.shape[1:3] for f in feats],
                                               self.strides, 0.5, device=flat.device)
        probs = torch.softmax(pred_distri.reshape(b, -1, 4, rm), dim=-1)
        dist = probs @ torch.arange(rm, dtype=torch.float32, device=flat.device)
        pred_bboxes = dist2bbox(dist, anchor_points, xywh=False)   # grid units

        gt_bboxes = batch["gt_bboxes"].float()
        assign = heuristic_assign_v1(
            torch.sigmoid(pred_scores).detach(), (pred_bboxes * stride_t).detach(),
            anchor_points * stride_t, batch["gt_labels"], gt_bboxes, batch["mask_gt"],
            step, num_classes=self.nc, epoch_num=self.epoch_num, topk=self.tal_topk,
            beta=self.tal_beta)
        target_scores = assign.target_scores
        tss = target_scores.sum().clamp(min=1.0)
        loss_cls = _bce_logits(pred_scores, target_scores).sum() / tss

        target_bboxes = assign.target_bboxes / stride_t
        weight = target_scores.sum(-1) * assign.fg_mask
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True).squeeze(-1)
        loss_box = ((1.0 - iou) * weight).sum() / tss
        target_ltrb = bbox2dist(anchor_points, target_bboxes, rm - 1)
        dfl = _df_loss(pred_distri.reshape(b, -1, 4, rm), target_ltrb) * weight
        loss_dfl = dfl.sum() / tss
        return {"b": b, "shapes": [f.shape[1:3] for f in feats], "anchor_points": anchor_points,
                "stride_tensor": stride_t, "assign": assign, "fg": assign.fg_mask,
                "target_bboxes": target_bboxes, "weight": weight, "loss_cls": loss_cls,
                "loss_box": loss_box, "loss_dfl": loss_dfl}


def pad_targets(batch_idx, cls, bboxes_xywhn, batch_size: int, max_gt: int,
                imgsz: Tuple[int, int]):
    """Flat (N,) image index / (N,) class / (N, 4) normalised xywh ->
    padded (b, max_gt) labels, (b, max_gt, 4) xyxy pixel boxes and mask,
    through `data.build.pad_boxes`."""
    h, w = imgsz
    idx = np.asarray(batch_idx)
    boxes, labels = [], []
    for j in range(batch_size):
        sel = idx == j
        bb = np.asarray(bboxes_xywhn)[sel].astype(np.float32)
        xy, wh = bb[:, :2] * [w, h], bb[:, 2:] * [w, h]
        boxes.append(np.concatenate([xy - wh / 2, xy + wh / 2], -1))
        labels.append(np.asarray(cls)[sel])
    return pad_boxes(boxes, labels, max_gt)
