"""Flips, HSV jitter and normalisation of uint8 training images: the plain
PyTorch version of K3, the counterpart of `fused_augment` in
`mgdt_yolo_tpu/ops/pallas_image.py` (the XLA twin of the TPU kernel
`fused_augment_pallas`).

The CUDA kernel (`csrc/fused_augment.cu`, wrapped by `ops/cuda_image.py`)
computes the same function; this version serves CPU tensors and is what the
kernel is held against on the card. The float32 operations follow the JAX
code one for one: `/ 255.0` as a division, the `1e-12` epsilons, the
`cmax == r` before `cmax == g` branch order, floor-mod (`torch.remainder`,
as `jnp.remainder`) for `% 6.0`, `% 1.0` and `% 2.0`, and the five-step
`sector < k + 0.5` cascade that picks each channel's case.
"""
from __future__ import annotations

import torch


def hsv_adjust(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor, gains: torch.Tensor):
    """Continuous HSV gain on [0, 1] RGB planes (any shape); `gains` (..., 3)
    broadcasts against the planes (h, s, v multiplicative gains)."""
    cmax = torch.maximum(r, torch.maximum(g, b))
    cmin = torch.minimum(r, torch.minimum(g, b))
    delta = cmax - cmin + 1e-12
    h = torch.where(cmax == r, torch.remainder((g - b) / delta, 6.0),
                    torch.where(cmax == g, (b - r) / delta + 2.0,
                                (r - g) / delta + 4.0)) / 6.0
    s = delta / (cmax + 1e-12)
    v = cmax
    h = torch.remainder(h * gains[..., 0], 1.0)
    s = torch.clamp(s * gains[..., 1], 0.0, 1.0)
    v = torch.clamp(v * gains[..., 2], 0.0, 1.0)
    h6 = h * 6.0
    c = v * s
    xx = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    m = v - c
    sector = torch.remainder(torch.floor(h6), 6.0)
    zeros = c * 0.0

    def pick(cases):
        out = cases[5]
        for k in range(4, -1, -1):
            out = torch.where(sector < k + 0.5, cases[k], out)
        return out

    r2 = pick([c, xx, zeros, zeros, xx, c]) + m
    g2 = pick([xx, c, c, xx, zeros, zeros]) + m
    b2 = pick([zeros, zeros, xx, c, c, xx]) + m
    return r2, g2, b2


def apply_flips_u8(images_u8: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images with `flips` (B, 2) [left-right, up-down] flags
    applied per image."""
    flips = flips.to(torch.int32)
    lr = flips[:, 0, None, None, None] > 0
    images_u8 = torch.where(lr, images_u8.flip(2), images_u8)
    ud = flips[:, 1, None, None, None] > 0
    return torch.where(ud, images_u8.flip(1), images_u8)


def fused_augment_plain(images_u8: torch.Tensor, hsv_gains: torch.Tensor,
                        flips: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB, gains (B, 3) float32, flips (B, 2) int ->
    (B, H, W, 3) float32 in [0, 1], flipped and HSV-adjusted."""
    x = apply_flips_u8(images_u8, flips).to(torch.float32) / 255.0
    gains = hsv_gains.to(torch.float32)[:, None, None, :]
    r, g, b = hsv_adjust(x[..., 0], x[..., 1], x[..., 2], gains)
    return torch.stack([r, g, b], dim=-1)
