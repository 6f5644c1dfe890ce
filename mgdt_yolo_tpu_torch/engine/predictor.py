"""Batch prediction: images in, fixed-size detections out.

The counterpart of the JAX predictor's inference step
(`mgdt_yolo_tpu/engine/predictor.py`, `BasePredictor.setup_model.infer`):
scale uint8 by 1/255, run the eval forward, then NMS with the serving
settings of the JAX benchmark (`bench.py`). Images must already be at the
model's input size; letterboxing images of any size is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.nms import non_max_suppression

CONF, IOU, MAX_DET, PRE_TOPK, BLOCK = 0.25, 0.7, 300, 1024, 256


@torch.no_grad()
def predict(model, images):
    """Detect objects in an NHWC RGB batch (uint8, or float in [0, 1]).

    `images` is a numpy array or tensor (B, H, W, 3) with H and W multiples
    of the model's largest stride. Runs on the model's device. Returns
    (det (B, MAX_DET, 6) [x1, y1, x2, y2, conf, cls] zero-padded,
    counts (B,) int32).
    """
    x = images if torch.is_tensor(images) else torch.from_numpy(np.ascontiguousarray(images))
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(x.shape)}")
    x = x.to(model.device)
    if not x.is_floating_point():
        x = x.float() / 255.0
    decoded, _ = model(x)
    return non_max_suppression(decoded, conf_thres=CONF, iou_thres=IOU,
                               max_det=MAX_DET, pre_topk=PRE_TOPK, block=BLOCK)
