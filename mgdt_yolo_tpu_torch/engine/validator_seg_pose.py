"""The segment and pose validators, the counterparts of
`mgdt_yolo_tpu/engine/validator_seg_pose.py`: box mAP plus mask mAP over
prototype-assembled masks, or plus OKS keypoint mAP.

On the device, the eval forward and the NMS (conf `args["conf"]` or 0.001,
IoU `args["iou"]`, every class of an anchor a candidate, `max_det`, the
NMS's default 1024-deep pool in blocks of 256, as the JAX validators call
it) with `return_idx`, which gathers each kept row's mask coefficients or
decoded keypoints. On the host, as in JAX, matching happens in the
letterboxed frame of the batch (no `scale_boxes`): boxes by
`match_predictions`, masks by `mask_iou_matrix` between the kept rows'
masks (sigmoid of prototypes x coefficients > 0.5 at prototype
resolution) and the batch's mask planes resized nearest to it, keypoints
by `kpt_oks_matrix` with the COCO sigmas and the boxes' areas; both through
`_match_by_matrix`, the greedy unique matching of `match_predictions` over
another similarity. Results: `box_*`, `mask_*` or `kpt_*` of each
`DetMetrics`, and `fitness` from the box metrics. The model runs in
float32, or in bf16 autocast with `half`, as the detect validator.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..cfg.default import TRAIN_DEFAULTS
from ..data.imgproc import resize_nearest
from ..ops.nms import non_max_suppression
from ..utils.loss_seg_pose import OKS_SIGMA
from ..utils.metrics import DetMetrics, match_predictions

LOGGER = logging.getLogger(__name__)


def mask_iou_matrix(gt_masks: np.ndarray, pred_masks: np.ndarray,
                    eps: float = 1e-7) -> np.ndarray:
    """(G, H, W) x (N, H, W) binary -> (G, N) IoU."""
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float32)
    p = pred_masks.reshape(len(pred_masks), -1).astype(np.float32)
    inter = g @ p.T
    union = g.sum(1)[:, None] + p.sum(1)[None] - inter
    return inter / (union + eps)


def kpt_oks_matrix(gt_kpts: np.ndarray, pred_kpts: np.ndarray, areas: np.ndarray,
                   sigmas: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(G, K, 3) x (N, K, 2|3) -> (G, N) OKS over the visible keypoints."""
    d2 = ((gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2 +
          (gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]) ** 2)
    vis = (gt_kpts[..., 2] > 0)[:, None]
    e = d2 / (2 * sigmas[None, None]) ** 2 / (areas[:, None, None] + eps) / 2
    return (np.exp(-e) * vis).sum(-1) / (vis.sum(-1) + eps)


def _match_by_matrix(sim: np.ndarray, gt_cls, pred_cls, thresholds) -> np.ndarray:
    """(N, T) true positives: per threshold, pairs of one class at or above
    it, by similarity descending, each prediction and each label once."""
    tp = np.zeros((sim.shape[1], len(thresholds)), bool)
    sim = sim * (np.asarray(gt_cls)[:, None] == np.asarray(pred_cls)[None, :])
    for t, thr in enumerate(thresholds):
        gi, pi = np.nonzero(sim >= thr)
        if gi.size:
            order = sim[gi, pi].argsort()[::-1]
            m = np.stack([gi, pi], 1)[order]
            m = m[np.unique(m[:, 1], return_index=True)[1]]
            m = m[np.unique(m[:, 0], return_index=True)[1]]
            tp[m[:, 1], t] = True
    return tp


class _TaskValidator:
    """What the two validators share: the arguments, the loader, the
    device pass and the box metrics."""
    task = "detect"
    extra = "extra"

    def __init__(self, args: Optional[Dict] = None):
        self.args = {**TRAIN_DEFAULTS, "half": False, **(args or {})}
        self.iouv = np.linspace(0.5, 0.95, 10)

    @torch.no_grad()
    def infer(self, model, img: torch.Tensor):
        """(det, counts, kept anchors, decoded, aux) of one uint8 batch."""
        a, dev = self.args, model.device
        x = img.to(dev)
        if not x.is_floating_point():
            x = x.float() / 255.0
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bool(a["half"])):
            decoded, aux = model(x)
        det, cnt, idx = non_max_suppression(decoded.float(), conf_thres=a["conf"] or 0.001,
                                            iou_thres=a["iou"], max_det=a["max_det"],
                                            multi_label=True, nc=model.nc, return_idx=True)
        return det, cnt, idx, decoded, aux

    def __call__(self, model, loader=None) -> Dict[str, float]:
        """Validate `model` (put in `eval()` mode) over `loader`, by default
        the `val` split of `args["data"]` for this task (the synthetic
        validation scenes at the full `imgsz` when it is None). A model of
        another task raises (JAX's would fail on its missing planes)."""
        if getattr(model, "task", "detect") != self.task:
            raise ValueError(f"the {self.task} validator needs a {self.task} model, not a "
                             f"{getattr(model, 'task', 'detect')} one")
        if loader is None:
            from .trainer import build_loader
            loader = build_loader({**self.args, "rect": False}, False, model)
        model.eval()
        box_m, extra_m = DetMetrics(), DetMetrics()
        n_img = 0
        for batch in loader:
            det, cnt, rows = self.rows(model, batch)
            for j in range(len(det)):
                n = int(cnt[j])
                d = det[j][:n]
                gm = batch["mask_gt"][j]
                gt_boxes = batch["gt_bboxes"][j][gm]
                gt_cls = batch["gt_labels"][j][gm].astype(float)
                box_m.update(match_predictions(d[:, :4], d[:, 5], gt_boxes, gt_cls, self.iouv),
                             d[:, 4], d[:, 5], gt_cls)
                tp = self.match(batch, j, gm, d, gt_boxes, gt_cls, rows[j][:n])
                extra_m.update(tp, d[:, 4], d[:, 5], gt_cls)
                n_img += 1
        rb, rx = box_m.process(), extra_m.process()
        out = {f"box_{k}": v for k, v in rb.items()}
        out.update({f"{self.extra}_{k}": v for k, v in rx.items()})
        out["fitness"] = rb["fitness"]
        self.metrics = (box_m, extra_m)
        LOGGER.info(f"{self.task} val: {n_img} imgs  box mAP50 {rb['map50']:.3f}  "
                    f"{self.extra} mAP50 {rx['map50']:.3f}")
        return out


class SegmentationValidator(_TaskValidator):
    """`validator(model, loader)` -> {box_*, mask_*, fitness}; see the
    module's text."""
    task, extra = "segment", "mask"

    def rows(self, model, batch):
        det, cnt, idx, _, (_, mc, proto) = self.infer(model, torch.from_numpy(batch["img"]))
        coefs = torch.gather(mc.float(), 1, idx.clamp(min=0).long()[..., None].expand(
            -1, -1, mc.shape[-1]))
        self.proto = proto.float().cpu().numpy()
        return det.cpu().numpy(), cnt.cpu().numpy(), coefs.cpu().numpy()

    def match(self, batch, j, gm, d, gt_boxes, gt_cls, coefs):
        n = len(d)
        gt_masks = batch["masks"][j][gm] > 0.5
        if not (n and len(gt_masks)):
            return np.zeros((n, 10), bool)
        ph, pw, nm = self.proto.shape[1:]
        pm = 1 / (1 + np.exp(-(self.proto[j].reshape(-1, nm) @ coefs.T)))
        pm = pm.T.reshape(n, ph, pw) > 0.5
        gt_rs = np.stack([resize_nearest(m.astype(np.uint8), (pw, ph)) for m in gt_masks]) > 0
        return _match_by_matrix(mask_iou_matrix(gt_rs, pm), gt_cls, d[:, 5], self.iouv)


class PoseValidator(_TaskValidator):
    """`validator(model, loader)` -> {box_*, kpt_*, fitness}; see the
    module's text."""
    task, extra = "pose", "kpt"

    def rows(self, model, batch):
        det, cnt, idx, decoded, _ = self.infer(model, torch.from_numpy(batch["img"]))
        tail = decoded[:, 4 + model.nc:].transpose(1, 2).float()
        kpts = torch.gather(tail, 1, idx.clamp(min=0).long()[..., None].expand(
            -1, -1, tail.shape[-1]))
        self.kpt_shape = tuple(model.kpt_shape)
        return det.cpu().numpy(), cnt.cpu().numpy(), kpts.cpu().numpy()

    def match(self, batch, j, gm, d, gt_boxes, gt_cls, kpts):
        n = len(d)
        gt_k = batch["keypoints"][j][gm]
        if not (n and len(gt_k)):
            return np.zeros((n, 10), bool)
        areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        pk = kpts.reshape(n, *self.kpt_shape)
        k = self.kpt_shape[0]  # JAX's validator takes COCO's sigmas for any 17 keypoints
        sim = kpt_oks_matrix(gt_k, pk, areas, OKS_SIGMA if k == 17 else np.ones(k) / k)
        return _match_by_matrix(sim, gt_cls, d[:, 5], self.iouv)
