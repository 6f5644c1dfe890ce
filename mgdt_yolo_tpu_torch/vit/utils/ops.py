"""Hungarian matching and contrastive denoising groups for DETR training,
the counterparts of `mgdt_yolo_tpu/vit/utils/ops.py`.

The matching cost is computed on the tensors' device; the optimal
assignment runs on the host (scipy's `linear_sum_assignment`, after
`nan_to_num`, on the valid ground-truth columns), one round trip per
supervised layer, as JAX's host callback does. The denoising group's noise
is drawn from an explicit `torch.Generator` (`cdn_noise`), or passed in.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...ops.boxes import bbox_iou, xywh2xyxy, xyxy2xywh


def host_assign(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The column matched to each row of `cost` (nq, G), -1 where none,
    over the first `valid.sum()` columns (the padded targets come last)."""
    import scipy.optimize
    g = int(valid.sum())
    out = np.full(cost.shape[0], -1, np.int64)
    if g == 0:
        return out
    c = np.nan_to_num(cost[:, :g], nan=1e6, posinf=1e6, neginf=-1e6)
    rows, cols = scipy.optimize.linear_sum_assignment(c)
    out[rows] = cols
    return out


def _as_loss_type(t: torch.Tensor) -> torch.Tensor:
    """A prediction in float32, or float64 where it is (a 16-bit one
    widened)."""
    return t if t.dtype == torch.float64 else t.float()


class HungarianMatcher:
    """Optimal bipartite matching of queries to targets with DETR's cost,
    JAX's arguments and defaults: gains class 2, L1 box 5, GIoU 2; the class
    cost focal-modulated (alpha 0.25, gamma 2) with `use_fl`, else the plain
    `-score`."""

    def __init__(self, cost_gain: Optional[Dict[str, float]] = None, use_fl: bool = True,
                 alpha: float = 0.25, gamma: float = 2.0):
        self.cost_gain = cost_gain or {"class": 2, "bbox": 5, "giou": 2}
        self.use_fl = use_fl
        self.alpha = alpha
        self.gamma = gamma

    @torch.no_grad()
    def cost(self, pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt) -> torch.Tensor:
        """(b, nq, G) cost, 1e6 at padded targets. Boxes are normalised
        xywh, scores logits; the class term is float32 as JAX's."""
        b, nq, _ = pred_scores.shape
        G = gt_bboxes.shape[1]
        pred_bboxes = _as_loss_type(pred_bboxes)
        scores = torch.sigmoid(pred_scores.float())
        sc = torch.gather(scores, 2, gt_cls.long()[:, None, :].expand(b, nq, G))
        if self.use_fl:
            neg = (1 - self.alpha) * sc ** self.gamma * (-torch.log1p(-sc + 1e-8))
            pos = self.alpha * (1 - sc) ** self.gamma * (-torch.log(sc + 1e-8))
            cost_class = pos - neg
        else:
            cost_class = -sc
        cost_bbox = (pred_bboxes[:, :, None, :] - gt_bboxes[:, None, :, :]).abs().sum(-1)
        cost_giou = -bbox_iou(xywh2xyxy(pred_bboxes)[:, :, None, :],
                              xywh2xyxy(gt_bboxes)[:, None, :, :], xywh=False,
                              GIoU=True).squeeze(-1)
        g = self.cost_gain
        cost = g["class"] * cost_class + g["bbox"] * cost_bbox + g["giou"] * cost_giou
        return torch.where(mask_gt[:, None, :], cost, torch.full_like(cost, 1e6))

    def __call__(self, pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt) -> torch.Tensor:
        """(b, nq) int64 on the predictions' device: the target matched to
        each query, -1 where none."""
        cost = self.cost(pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt)
        c, v = cost.cpu().numpy(), mask_gt.cpu().numpy()
        idx = np.stack([host_assign(ci, vi) for ci, vi in zip(c, v)])
        return torch.from_numpy(idx).to(pred_bboxes.device)


def cdn_noise(b: int, D: int, num_classes: int, generator: Optional[torch.Generator] = None,
              device=None) -> Dict[str, torch.Tensor]:
    """The denoising group's random draws for `b` images of `D` queries:
    `flip` (b, D) uniform (a label is replaced where it is below half the
    noise ratio), `cls` (b, D) the replacement labels, `sign` (b, D, 4)
    +-1 and `part` (b, D, 4) uniform (the box noise's direction and size),
    drawn on the CPU from `generator` and moved to `device`."""
    g = generator
    out = {"flip": torch.rand((b, D), generator=g),
           "cls": torch.randint(0, num_classes, (b, D), generator=g),
           "sign": torch.randint(0, 2, (b, D, 4), generator=g).float() * 2 - 1,
           "part": torch.rand((b, D, 4), generator=g)}
    return {k: v.to(device) for k, v in out.items()}


def get_cdn_group(gt_cls: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor,
                  num_classes: int, num_queries: int, class_embed: torch.Tensor,
                  num_dn: int = 100, cls_noise_ratio: float = 0.5,
                  box_noise_scale: float = 1.0, noise: Optional[Dict[str, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None):
    """The contrastive denoising group at fixed shapes, as JAX builds it:
    every image contributes 2 G queries a group (its padded targets, then
    the same as negatives, whose box noise is 1 to 2 half-sizes), G the
    padded target count, with max(1, num_dn // G) groups, so D = 2 G
    groups. `noise` (`cdn_noise`'s keys) or draws from `generator`.

    Returns (dn_embed (b, D, hd), dn_bbox (b, D, 4) logit-space xywh,
    attn_mask (nq + D, nq + D) bool, True where blocked, dn_meta), or four
    Nones without targets."""
    b, G = gt_cls.shape
    if G == 0 or num_dn <= 0:
        return None, None, None, None
    num_group = max(1, num_dn // max(G, 1))
    D = 2 * G * num_group
    dev = gt_bboxes.device
    if noise is None:
        noise = cdn_noise(b, D, num_classes, generator, dev)
    cls = gt_cls.long().repeat(1, 2 * num_group)
    box = gt_bboxes.repeat(1, 2 * num_group, 1)
    valid = mask_gt.repeat(1, 2 * num_group)
    neg_idx = (torch.arange(D, device=dev) % (2 * G)) >= G
    if cls_noise_ratio > 0:
        flip = noise["flip"] < cls_noise_ratio * 0.5
        cls = torch.where(flip & valid, noise["cls"].long(), cls)
    if box_noise_scale > 0:
        wh = box[..., 2:]
        diff = torch.cat([wh / 2, wh / 2], -1) * box_noise_scale
        part = torch.where(neg_idx[None, :, None], noise["part"] + 1.0, noise["part"])
        xyxy = (xywh2xyxy(box) + part * noise["sign"] * diff).clamp(0, 1)
        box = xyxy2xywh(xyxy)
    dn_embed = class_embed[cls]
    dn_bbox = torch.log(box.clamp(min=1e-5) / (1 - box).clamp(min=1e-5))

    total = num_queries + D
    mask = np.zeros((total, total), bool)
    mask[D:, :D] = True  # the matched queries cannot see the denoising ones
    gs = 2 * G
    for g in range(num_group):  # nor a group the others
        s, e = g * gs, (g + 1) * gs
        mask[s:e, :s] = True
        mask[s:e, e:D] = True
    dn_meta = {"dn_num_group": num_group, "dn_num_split": [D, num_queries], "group_size": gs,
               "dn_pos_idx_is_first_half": True, "dn_valid": valid, "dn_cls": cls,
               "neg_idx": neg_idx}
    return dn_embed, dn_bbox, torch.from_numpy(mask).to(dev), dn_meta
