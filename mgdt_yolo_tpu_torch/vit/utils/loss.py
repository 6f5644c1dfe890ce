"""The DETR loss: varifocal classification and L1 + GIoU box losses over
Hungarian-matched pairs, per decoder layer, with the encoder's proposals
and the denoising group supervised too; the counterpart of
`mgdt_yolo_tpu/vit/utils/loss.py`. Computed in float32 (float64 where the
predictions are), with JAX's float32 casts of the class logits.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.boxes import bbox_iou, xywh2xyxy
from .ops import HungarianMatcher, _as_loss_type


def _bce(logits, targets):
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = _bce(logits, targets) * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


def varifocal_loss(logits, gt_score, label, alpha: float = 0.75, gamma: float = 2.0):
    """IoU-aware classification: positives weighted by their target IoU,
    negatives by alpha p^gamma."""
    p = torch.sigmoid(logits)
    weight = alpha * p ** gamma * (1 - label) + gt_score * label
    return _bce(logits, gt_score) * weight


class DETRLoss:
    """Every layer's loss, with JAX's arguments and defaults: varifocal
    classification (`use_vfl`; a batch without targets takes the focal
    loss), focal alone (`use_vfl=False`), or softmax cross-entropy
    (`use_fl=False` too); the parts scaled by `loss_gain` (class 1, bbox 5,
    giou 2). The last layer's keys are unsuffixed, the others `_aux{i}`,
    the denoising layers' `_dn{i}`."""

    def __init__(self, nc: int = 80, loss_gain: Optional[Dict] = None, use_vfl: bool = True,
                 use_fl: bool = True):
        self.nc = nc
        self.loss_gain = loss_gain or {"class": 1, "bbox": 5, "giou": 2}
        self.use_vfl = use_vfl
        self.use_fl = use_fl
        self.matcher = HungarianMatcher(use_fl=use_fl)

    def layer_loss(self, pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt,
                   match_idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One layer's (b, nq, ...) predictions against the targets, matched
        by the Hungarian matcher unless `match_idx` (b, nq) is given."""
        pred_bboxes = _as_loss_type(pred_bboxes)
        if match_idx is None:
            match_idx = self.matcher(pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt)
        safe = match_idx.clamp(0, gt_bboxes.shape[1] - 1)
        tgt_box = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
        tgt_cls = torch.gather(gt_cls.long(), 1, safe)
        tgt_valid = (match_idx >= 0) & torch.gather(mask_gt, 1, safe)
        n_valid = tgt_valid.sum()
        n_gt = n_valid.clamp(min=1).float()
        onehot = F.one_hot(tgt_cls, self.nc).to(pred_bboxes.dtype) * tgt_valid[..., None]
        logits = pred_scores.float()
        if self.use_vfl:
            iou = bbox_iou(xywh2xyxy(pred_bboxes), xywh2xyxy(tgt_box), xywh=False).squeeze(-1)
            iou = iou.clamp(0, 1).detach() * tgt_valid
            vfl = varifocal_loss(logits, onehot * iou[..., None], onehot).sum() / n_gt
            # a batch without targets takes the focal loss (gamma 1.5), as the
            # reference's `if num_gts and self.vfl` does
            fl = sigmoid_focal_loss(logits, onehot, gamma=1.5).sum() / n_gt
            loss_cls = torch.where(n_valid > 0, vfl, fl)
        elif self.use_fl:
            loss_cls = sigmoid_focal_loss(logits, onehot, gamma=1.5).sum() / n_gt
        else:
            loss_cls = -(onehot * F.log_softmax(logits, -1)).sum() / n_gt
        l1 = (pred_bboxes - tgt_box).abs().sum(-1) * tgt_valid
        giou = bbox_iou(xywh2xyxy(pred_bboxes), xywh2xyxy(tgt_box), xywh=False,
                        GIoU=True).squeeze(-1)
        g = self.loss_gain
        return {"loss_class": g["class"] * loss_cls,
                "loss_bbox": g["bbox"] * (l1.sum() / n_gt),
                "loss_giou": g["giou"] * (((1.0 - giou) * tgt_valid).sum() / n_gt)}

    def __call__(self, pred_bboxes, pred_scores, batch: Dict, dn_meta: Optional[Dict] = None,
                 dn_bboxes=None, dn_scores=None) -> Tuple[torch.Tensor, Dict]:
        """pred_bboxes/scores: (L, b, nq, ...) stacked layers; batch:
        `gt_bboxes_norm` (b, G, 4) xywh in [0, 1], `gt_labels`, `mask_gt`.
        Returns (the sum of every part, {name: part})."""
        gt_bboxes, gt_cls, mask_gt = batch["gt_bboxes_norm"], batch["gt_labels"], batch["mask_gt"]
        total = {}
        L = pred_bboxes.shape[0]
        for li in range(L):
            parts = self.layer_loss(pred_bboxes[li], pred_scores[li], gt_bboxes, gt_cls, mask_gt)
            suffix = "" if li == L - 1 else f"_aux{li}"
            total.update({k + suffix: v for k, v in parts.items()})
        if dn_meta is not None and dn_bboxes is not None:
            # a denoising query's target is known: query j of a group is
            # target j % G in the positive half, background in the negative
            G, D = gt_bboxes.shape[1], dn_bboxes.shape[2]
            gt_idx = (torch.arange(D, device=gt_bboxes.device) % G)[None].expand(
                gt_bboxes.shape[0], -1)
            match_idx = torch.where((~dn_meta["neg_idx"])[None] & dn_meta["dn_valid"], gt_idx,
                                    torch.full_like(gt_idx, -1))
            for li in range(dn_bboxes.shape[0]):
                parts = self.layer_loss(dn_bboxes[li], dn_scores[li], gt_bboxes, gt_cls,
                                        mask_gt, match_idx=match_idx)
                total.update({f"{k}_dn{li}": v for k, v in parts.items()})
        return sum(total.values()), total


class RTDETRDetectionLoss(DETRLoss):
    """RT-DETR's loss: the encoder's top-k proposals supervised as a first
    layer before the decoder's, and the denoising queries (the first D of
    every decoder layer) split off where `dn_meta` is given."""

    def __call__(self, outputs, batch: Dict, dn_meta: Optional[Dict] = None):
        dec_bboxes, dec_scores, enc_bboxes, enc_scores = outputs[:4]
        dn_b = dn_s = None
        if dn_meta is not None:
            D = dn_meta["dn_num_split"][0]
            dn_b, dec_bboxes = dec_bboxes[:, :, :D], dec_bboxes[:, :, D:]
            dn_s, dec_scores = dec_scores[:, :, :D], dec_scores[:, :, D:]
        all_b = torch.cat([_as_loss_type(enc_bboxes)[None], _as_loss_type(dec_bboxes)])
        all_s = torch.cat([_as_loss_type(enc_scores)[None], _as_loss_type(dec_scores)])
        return super().__call__(all_b, all_s, batch, dn_meta, dn_b, dn_s)
