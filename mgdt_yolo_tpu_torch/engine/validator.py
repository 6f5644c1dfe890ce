"""Validation: the eval forward and the val NMS on the device, mAP and the
counting metrics on the host; the counterpart of `DetectionValidator` in
`mgdt_yolo_tpu/engine/validator.py`.

The model runs unfused in `eval()` mode, under bf16 autocast on the GPU when
`amp` is on (float32 otherwise), then NMS with the val protocol: conf
`args["conf"]` (0.001 when unset), IoU `args["iou"]`, every class of an
anchor a candidate (`multi_label`), classes kept apart unless
`args["agnostic_nms"]`, a 4096-deep candidate pool resolved in
blocks of 1024, `max_det` survivors. Detections and labels go back through
each image's letterbox (`scale_boxes` with its `ratio_pad`) and feed
`match_predictions`, `DetMetrics`, `ConfusionMatrix` and
`counting_agreement`, as in the JAX validator. Called without a loader,
it validates on the `val` split of `args["data"]` (a dataset YAML or
directory; the JAX trainer's synthetic validation set when it is None),
as the JAX validator does standalone. Not ported: COCO json and COCOeval,
plots, rectangular batches.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..cfg.default import TRAIN_DEFAULTS
from ..ops.boxes import scale_boxes
from ..ops.nms import non_max_suppression
from ..utils.metrics import ConfusionMatrix, DetMetrics, counting_agreement, match_predictions

VAL_PRE_TOPK, VAL_BLOCK = 4096, 1024


class DetectionValidator:
    """`validator(model, loader)` -> {precision, recall, map50, map, fitness,
    speed_ms_per_image}. `args` replace keys of `cfg.default.TRAIN_DEFAULTS`
    (`conf`, `iou`, `max_det`, `agnostic_nms`, `amp`)."""

    def __init__(self, args: Optional[Dict] = None):
        self.args = {**TRAIN_DEFAULTS, **(args or {})}
        self.iouv = np.linspace(0.5, 0.95, 10)

    @torch.no_grad()
    def infer(self, model, img: torch.Tensor):
        """Detections (B, max_det, 6) and counts (B,) of one uint8 batch."""
        a = self.args
        dev = model.device
        x = img.to(dev)
        if not x.is_floating_point():
            x = x.float() / 255.0
        amp = bool(a["amp"]) and dev.type == "cuda"
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=amp):
            decoded, _ = model(x)
        return non_max_suppression(decoded.float(), conf_thres=a["conf"] or 0.001,
                                   iou_thres=a["iou"], max_det=a["max_det"],
                                   multi_label=True, agnostic=a["agnostic_nms"],
                                   pre_topk=VAL_PRE_TOPK, block=VAL_BLOCK, nc=model.nc)

    def __call__(self, model, loader=None) -> Dict[str, float]:
        """Validate `model` (put in `eval()` mode) over `loader`, a
        validation `DataLoader` (`train=False`); by default the `val` split
        of `args["data"]` (`engine.trainer.build_loader`)."""
        if loader is None:
            from .trainer import build_loader
            loader = build_loader(self.args, False, model)
        model.eval()
        metrics = DetMetrics()
        cm = ConfusionMatrix(model.nc)
        per_image_preds, per_image_gts = [], []
        t0 = time.time()
        for batch in loader:
            dets, counts = self.infer(model, torch.from_numpy(batch["img"]))
            dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
            in_shape = tuple(batch["img"].shape[1:3])
            for j in range(len(dets)):
                det = dets[j][:int(counts[j])]
                m = batch["metas"][j]
                gt_mask = batch["mask_gt"][j]
                gt_boxes = batch["gt_bboxes"][j][gt_mask]
                gt_cls = batch["gt_labels"][j][gt_mask].astype(float)
                det_s = det.copy()
                det_s[:, :4] = scale_boxes(in_shape, det[:, :4], m["ori_shape"], m["ratio_pad"])
                gt_s = (scale_boxes(in_shape, gt_boxes.copy(), m["ori_shape"], m["ratio_pad"])
                        if len(gt_boxes) else gt_boxes)
                tp = match_predictions(det_s[:, :4], det_s[:, 5], gt_s, gt_cls, self.iouv)
                metrics.update(tp, det_s[:, 4], det_s[:, 5], gt_cls)
                cm.process_batch(det_s, gt_s, gt_cls)
                per_image_preds.append(det_s)
                per_image_gts.append((gt_s, gt_cls))
        results = metrics.process()
        self.metrics, self.confusion_matrix = metrics, cm
        self.per_image_preds, self.per_image_gts = per_image_preds, per_image_gts
        self.counting_stats, self.count_r2 = counting_agreement(
            per_image_preds, per_image_gts, list(range(model.nc)))
        results["speed_ms_per_image"] = (time.time() - t0) / max(len(per_image_preds), 1) * 1000
        return results
