"""Box geometry for decode, NMS, the training loss and validation (last-dim
layouts, as in the JAX package)."""
from __future__ import annotations

import math

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2), last-dim layout."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def make_anchors(feat_shapes, strides, grid_cell_offset: float = 0.5,
                 dtype=torch.float32, device=None):
    """Grid anchor centres and per-anchor stride from (h, w) map shapes.

    Returns (anchor_points (A, 2) in grid units as (x, y), stride (A, 1)).
    """
    points, stride_t = [], []
    for (h, w), stride in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        syy, sxx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([sxx, syy], dim=-1).reshape(-1, 2))
        stride_t.append(torch.full((h * w, 1), float(stride), dtype=dtype,
                                   device=device))
    return torch.cat(points), torch.cat(stride_t)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True, dim: int = -1) -> torch.Tensor:
    """ltrb distances -> boxes around anchor points."""
    lt, rb = distance.chunk(2, dim=dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=dim)
    return torch.cat([x1y1, x2y2], dim=dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor,
              reg_max: float) -> torch.Tensor:
    """xyxy boxes -> ltrb distances clipped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points],
                     dim=-1).clamp(0, reg_max - 0.01)


def clip_boxes(boxes: np.ndarray, shape) -> np.ndarray:
    """Clip xyxy boxes (last dim 4, or more with extra columns kept) to an
    image of `shape` (h, w, ...); returns a copy."""
    h, w = shape[:2]
    out = boxes.copy()
    out[..., [0, 2]] = out[..., [0, 2]].clip(0, w)
    out[..., [1, 3]] = out[..., [1, 3]].clip(0, h)
    return out


def scale_boxes(img1_shape, boxes: np.ndarray, img0_shape, ratio_pad=None) -> np.ndarray:
    """Undo a letterbox: xyxy boxes (extra columns kept) from model-input
    space `img1_shape` back to the original image `img0_shape`, with the
    JAX package's (and the reference's) rounding. `ratio_pad` ((ratio,
    ratio), (dw, dh)) is the letterbox's own; without it the gain and pads
    are recomputed from the shapes."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
               round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1))
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    boxes = boxes.copy()
    boxes[..., [0, 2]] -= pad[0]
    boxes[..., [1, 3]] -= pad[1]
    boxes[..., :4] /= gain
    return clip_boxes(boxes, img0_shape)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
             CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU, or CIoU, of broadcast box arrays -> (..., 1).

    As the JAX package computes it: xyxy heights carry `+ eps`, and CIoU's
    aspect weight `alpha` is taken without gradient.
    """
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, dim=-1)
        x2, y2, w2, h2 = box2.chunk(4, dim=-1)
        b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.chunk(4, dim=-1)
        b2x1, b2y1, b2x2, b2y2 = box2.chunk(4, dim=-1)
        w1, h1 = b1x2 - b1x1, (b1y2 - b1y1) + eps
        w2, h2 = b2x2 - b2x1, (b2y2 - b2y1) + eps
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) *
             (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not CIoU:
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
