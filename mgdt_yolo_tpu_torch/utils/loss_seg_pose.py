"""The segment and pose training losses, the counterparts of
`mgdt_yolo_tpu/utils/loss_seg_pose.py`, on `DetectionLoss.detection_core`.

* `SegmentationLoss`: the detection loss plus each foreground anchor's
  prototype-mask BCE, cropped to its assigned box and normalised by the
  box's area. As in JAX, only the top K = min(10 * G, 256) anchors of each
  image by weight + 1 (foreground only; the +1 keeps an anchor whose
  weight is 0 in) are taken, the crop is half-open at prototype
  resolution, and the loss is each image's mean over its foreground
  anchors, summed over images.
* `PoseLoss`: the detection loss plus the OKS-style keypoint loss, each
  image's factor_i = its keypoint slots over its visible ones (+1e-9)
  times its mean, summed over images, and the visibility BCE.

The parts are `[box, seg, cls, dfl]` and `[box, kpt, kobj, cls, dfl]`, as
JAX's trainer lays them out. Float32, as `DetectionLoss`.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from .loss import DetectionLoss, LossOutputs, _bce_logits

LOGGER = logging.getLogger(__name__)

# COCO's 17 keypoint sigmas (the reference's OKS table)
OKS_SIGMA = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
                      1.07, 1.07, .87, .87, .89, .89]) / 10.0


def kpt_sigmas(kpt_shape) -> np.ndarray:
    """The OKS sigmas: COCO's for 17 keypoints (of 3 values), else uniform."""
    if tuple(kpt_shape) == (17, 3):
        return OKS_SIGMA.copy()
    return np.ones(kpt_shape[0]) / kpt_shape[0]


def _area(xyxy: torch.Tensor) -> torch.Tensor:
    return (xyxy[..., 2] - xyxy[..., 0]) * (xyxy[..., 3] - xyxy[..., 1])


class SegmentationLoss(DetectionLoss):
    """Head output (raw NHWC maps, coefficients (b, A, nm), prototypes
    (b, mh, mw, nm)); batch key `masks` (b, G, mh, mw), one plane per
    padded box at prototype resolution."""

    def __init__(self, nc: int, reg_max: int, strides, nm: int = 32, **kw):
        super().__init__(nc, reg_max, strides, **kw)
        self.nm = nm

    def __call__(self, head_out, batch: Dict, step: int) -> LossOutputs:
        feats, mask_coefs, proto = head_out
        c = self.detection_core(feats, batch, step)
        b, shapes, assign, fg, weight = c["b"], c["shapes"], c["assign"], c["fg"], c["weight"]
        masks = batch["masks"].float()
        G = masks.shape[1]
        K = min(10 * G, 256)
        if 10 * G > 256:
            LOGGER.warning(f"seg mask loss caps at 256 fg anchors/image (max_gt={G}): "
                           "extreme-density images truncate")
        mh, mw = proto.shape[1:3]
        neg = torch.tensor(-1.0, device=weight.device)
        order = torch.sort(torch.where(fg, weight + 1.0, neg), dim=1, descending=True,
                           stable=True)
        sel_v, sel_idx = order.values[:, :K], order.indices[:, :K]
        sel_fg = sel_v > 0.0
        # the products in the model's type (float32 at least), as JAX's einsum
        # with a float32 result type takes them, then float32
        dt = torch.promote_types(mask_coefs.dtype, torch.float32)
        coefs = torch.gather(mask_coefs.to(dt), 1,
                             sel_idx[..., None].expand(-1, -1, mask_coefs.shape[-1]))
        sel_gt = torch.gather(assign.target_gt_idx, 1, sel_idx)
        tgt_m = torch.gather(masks, 1, sel_gt[:, :, None, None].expand(-1, -1, mh, mw))
        pred_m = torch.einsum("bkn,bhwn->bkhw", coefs, proto.to(dt)).float()
        sel_boxes = torch.gather(assign.target_bboxes, 1, sel_idx[..., None].expand(-1, -1, 4))
        img_w = shapes[0][1] * self.strides[0]
        img_h = shapes[0][0] * self.strides[0]
        norm = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32,
                            device=sel_boxes.device)
        xyxyn = sel_boxes / norm
        area = _area(xyxyn).clamp(min=1e-4)
        mxy = xyxyn * torch.tensor([mw, mh, mw, mh], dtype=torch.float32, device=norm.device)
        yy = torch.arange(mh, dtype=torch.float32, device=norm.device).reshape(1, 1, mh, 1)
        xx = torch.arange(mw, dtype=torch.float32, device=norm.device).reshape(1, 1, 1, mw)
        crop = ((xx >= mxy[..., 0, None, None]) & (xx < mxy[..., 2, None, None]) &
                (yy >= mxy[..., 1, None, None]) & (yy < mxy[..., 3, None, None]))
        per_anchor = (_bce_logits(pred_m, tgt_m) * crop).mean(dim=(2, 3)) / area
        n_fg = sel_fg.sum(dim=1)
        per_image = (per_anchor * sel_fg).sum(dim=1) / n_fg.clamp(min=1)
        loss_seg = torch.where(n_fg > 0, per_image, torch.zeros_like(per_image)).sum()
        bg, cg, dg = self.gains
        parts = torch.stack([c["loss_box"] * bg, loss_seg * bg / b, c["loss_cls"] * cg,
                             c["loss_dfl"] * dg])
        return LossOutputs(parts.sum() * b, parts.detach())


class PoseLoss(DetectionLoss):
    """Head output (raw NHWC maps, raw keypoints (b, A, nk)); batch key
    `keypoints` (b, G, k, 3) in input pixels, the visibility last."""

    def __init__(self, nc: int, reg_max: int, strides, kpt_shape=(17, 3),
                 pose_gain: float = 12.0, kobj_gain: float = 1.0, **kw):
        super().__init__(nc, reg_max, strides, **kw)
        self.kpt_shape = tuple(kpt_shape)
        self.pose_gain, self.kobj_gain = pose_gain, kobj_gain
        self.sigmas = torch.tensor(kpt_sigmas(self.kpt_shape), dtype=torch.float32)

    def __call__(self, head_out, batch: Dict, step: int) -> LossOutputs:
        feats, kpt_flat = head_out
        c = self.detection_core(feats, batch, step)
        b, assign, fg = c["b"], c["assign"], c["fg"]
        anchor_points, stride_t = c["anchor_points"], c["stride_tensor"]
        nk, kdim = self.kpt_shape
        k = kpt_flat.reshape(b, -1, nk, kdim)   # the model's type, promoted as JAX's
        pk_xy = k[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)
        gt_k = batch["keypoints"].float()
        sel_k = torch.gather(gt_k, 1, assign.target_gt_idx[:, :, None, None].expand(
            -1, -1, nk, gt_k.shape[-1]))
        sel_xy = sel_k[..., :2] / stride_t[None, :, None, :]
        vis = (sel_k[..., 2] > 0).float()
        area = _area(c["target_bboxes"]).clamp(min=1e-4)
        d2 = ((pk_xy - sel_xy) ** 2).sum(-1)
        sig = self.sigmas.to(d2.device)
        e = d2 / (2 * sig[None, None]) ** 2 / (area[..., None] + 1e-9) / 2
        fg_f = fg.float()
        n_fg = fg_f.sum(dim=1)
        total_i = n_fg * nk
        visible_i = (vis * fg_f[..., None]).sum(dim=(1, 2))
        factor_i = total_i / (visible_i + 1e-9)
        sum_elems = ((1 - torch.exp(-e)) * vis * fg_f[..., None]).sum(dim=(1, 2))
        mean_i = sum_elems / total_i.clamp(min=1.0)
        zero = torch.zeros_like(mean_i)
        loss_kpt = torch.where(n_fg > 0, factor_i * mean_i, zero).sum()
        if kdim == 3:
            bce_k = (_bce_logits(k[..., 2], vis) * fg_f[..., None]).sum(dim=(1, 2))
            loss_kobj = torch.where(n_fg > 0, bce_k / total_i.clamp(min=1.0), zero).sum()
        else:
            loss_kobj = zero.sum()
        bg, cg, dg = self.gains
        parts = torch.stack([c["loss_box"] * bg, loss_kpt * self.pose_gain / b,
                             loss_kobj * self.kobj_gain / b, c["loss_cls"] * cg,
                             c["loss_dfl"] * dg])
        return LossOutputs(parts.sum() * b, parts.detach())
