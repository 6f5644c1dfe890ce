"""Resampling and pooling for NCHW feature maps.

Nearest upsampling repeats values. Adaptive average pooling and bilinear
resizing are products with small
per-axis interpolation matrices, rebuilt here exactly as the JAX package
builds them (`mgdt_yolo_tpu/ops/common.py`), so both packages resample with
the same weights. The matrices are made with numpy and cached per size.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-stochastic matrix of adaptive_avg_pool1d: output cell i
    averages input indices [floor(i*in/out), ceil((i+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-((i + 1) * in_size) // out_size)  # ceil
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=256)
def _block_indicator(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) 0/1 block-membership matrix for divisible pooling."""
    k = in_size // out_size
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        m[i, i * k:(i + 1) * k] = 1.0
    return m


@functools.lru_cache(maxsize=256)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of a bilinear resize with align_corners=False."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w_hi = src - lo
        m[i, lo] += 1.0 - w_hi
        m[i, hi] += w_hi
    return m


def _apply_hw_matrices(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray
                       ) -> torch.Tensor:
    """Resample (B, C, H, W) with per-axis (out, in) matrices, in float32."""
    mh = torch.from_numpy(mh).to(x.device)
    mw = torch.from_numpy(mw).to(x.device)
    y = torch.einsum("oh,bchw->bcow", mh, x.float())
    y = torch.einsum("ow,bchw->bcho", mw, y)
    return y.to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """adaptive_avg_pool2d of a (B, C, H, W) map, by interpolation matrices."""
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else tuple(output_size))
    h, w = x.shape[2:]
    if (h, w) == (oh, ow):
        return x
    if oh == 1 and ow == 1:
        return x.mean(dim=(2, 3), keepdim=True)
    if h % oh == 0 and w % ow == 0:
        # block sums against 0/1 matrices (exact in any type), accumulated
        # in float32, then one scale
        eh = torch.from_numpy(_block_indicator(h, oh)).to(x.device)
        ew = torch.from_numpy(_block_indicator(w, ow)).to(x.device)
        y = torch.einsum("oh,bchw->bcow", eh, x.float())
        y = torch.einsum("ow,bchw->bcho", ew, y)
        return (y * (1.0 / ((h // oh) * (w // ow)))).to(x.dtype)
    return _apply_hw_matrices(x, _adaptive_pool_matrix(h, oh),
                              _adaptive_pool_matrix(w, ow))


def interpolate_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize (align_corners=False) of a (B, C, H, W) map."""
    oh, ow = tuple(size)
    h, w = x.shape[2:]
    if (h, w) == (oh, ow):
        return x
    return _apply_hw_matrices(x, _bilinear_matrix(h, oh), _bilinear_matrix(w, ow))


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour integer upsample of a (B, C, H, W) map: every value
    repeated `scale` times along H and W (an exact copy, no index arithmetic)."""
    b, c, h, w = x.shape
    return (x[:, :, :, None, :, None].expand(b, c, h, scale, w, scale)
            .reshape(b, c, h * scale, w * scale))


def max_pool2d_same(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """Max pool with symmetric padding kernel//2 (padding never wins)."""
    return F.max_pool2d(x, kernel, stride, padding=kernel // 2)


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """ReLU6(x + 3) / 6, the GD injection gate."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0
