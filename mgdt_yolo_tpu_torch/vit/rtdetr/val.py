"""RT-DETR's validator: mAP over the last decoder layer's queries, without
NMS; the counterpart of `mgdt_yolo_tpu/vit/rtdetr/val.py`.

The validation loader is the JAX validator's (square letterbox of `imgsz`,
`batch`, seeded), every query above `conf` (0.001 when unset) a detection
with its normalised box times `imgsz` (the letterboxed pixels the labels
are in), matched to the labels at IoU 0.5:0.95 into `DetMetrics`. The
model runs in eval mode in float32, or bf16 autocast with `half` (the
trainer passes its own `amp`).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ...cfg.default import TRAIN_DEFAULTS
from ...data.augment import letterbox
from ...data.build import DataLoader
from ...ops.boxes import xywh2xyxy
from ...utils.metrics import DetMetrics, match_predictions
from .predict import keep_queries, queries

LOGGER = logging.getLogger(__name__)


def square_letterbox(img: np.ndarray, imgsz: int):
    """The validator's square letterbox of a BGR image (JAX
    `vit/rtdetr/val.py:18-22`): (RGB float32 in [0, 1], {"ori_shape",
    "ratio_pad"})."""
    out, ratio, pad = letterbox(img, (imgsz, imgsz), scaleup=True)
    return out[..., ::-1].astype(np.float32) / 255.0, \
        {"ori_shape": img.shape[:2], "ratio_pad": (ratio, pad)}


def postprocess_queries(bboxes_norm: np.ndarray, scores: np.ndarray,
                        conf: float = 0.001) -> np.ndarray:
    """Rows [x1, y1, x2, y2, score, class] of the queries whose best class
    score is above `conf`, boxes left normalised (JAX
    `vit/rtdetr/val.py:25-35`; the validator and predictor scale theirs,
    `predict.keep_queries`)."""
    bb = xywh2xyxy(torch.from_numpy(np.asarray(bboxes_norm))).numpy()
    cls = scores.argmax(-1)
    val = scores.max(-1)
    keep = val > conf
    return np.concatenate([bb[keep], val[keep, None], cls[keep, None].astype(np.float32)], axis=1)


class RTDETRValidator:
    """`RTDETRValidator(args)(model, loader=None, dataset=None,
    max_batches=None)` -> {precision, recall, map50, map, fitness}."""

    def __init__(self, args: Optional[Dict] = None):
        self.args = {**TRAIN_DEFAULTS, "half": False, **(args or {})}
        self.iouv = np.linspace(0.5, 0.95, 10)

    @torch.no_grad()
    def __call__(self, model, loader=None, dataset=None,
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        a = self.args
        if loader is None:
            if dataset is None:
                from ...engine.trainer import get_dataset
                dataset = get_dataset(a, False, model)
            loader = DataLoader(dataset, a["batch"], a["imgsz"], seed=a["seed"], train=False)
        model.eval()
        dev = model.device
        conf = a["conf"] or 0.001
        metrics, n_img = DetMetrics(), 0
        for bi, batch in enumerate(loader):
            if max_batches and bi >= max_batches:
                break
            x = torch.from_numpy(batch["img"]).to(dev)
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bool(a["half"])):
                bboxes, scores = queries(model, x)
            bb = xywh2xyxy(bboxes.float()).cpu().numpy()
            sc = scores.float().cpu().numpy()
            for j in range(len(bb)):
                det = keep_queries(bb[j], sc[j], conf, scale=np.float32(a["imgsz"]))
                gm = batch["mask_gt"][j]
                gt_boxes = batch["gt_bboxes"][j][gm]
                gt_cls = batch["gt_labels"][j][gm].astype(float)
                tp = match_predictions(det[:, :4], det[:, 5], gt_boxes, gt_cls, self.iouv)
                metrics.update(tp, det[:, 4], det[:, 5], gt_cls)
                n_img += 1
        res = metrics.process()
        self.metrics = metrics
        LOGGER.info(f"rtdetr val: {n_img} imgs  mAP50 {res['map50']:.3f} "
                    f"mAP50-95 {res['map']:.3f}")
        return res
