"""Box geometry for decode and NMS (last-dim layouts, as in the JAX package)."""
from __future__ import annotations

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
