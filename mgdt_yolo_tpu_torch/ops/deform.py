"""Modulated deformable convolution v2 (DCNv2) in plain PyTorch, NHWC, 3x3,
stride 1, padding 1: the forward and the explicit backward, the references
for the CUDA kernels (`csrc/deform_fwd.cu` and `csrc/deform_bwd.cu`,
wrapped by `ops/cuda_deform.py`, which routes CPU tensors here).

Two semantics, pinned per model by the checkpoint's metadata
(`deform_semantics`), because weights trained under one do not transfer to
the other:

* ``windowed``: output pixel (i, j), tap (ty, tx) samples at
  ``py = i - 1 + ty + off_y`` (likewise x). The bilinear floor is clamped
  per tap to ``[i - 3 + ty, i + 1 + ty]`` (a reach of about +/-2 px around
  the tap's rest position) and the fraction is clipped to [0, 1]. This is
  the JAX package's `pallas_deform._fields` written in absolute
  coordinates; floor and fraction are taken in the same window-relative
  coordinate (``ty + off_y + 2``) so the rounding matches.
* ``exact``: a plain bilinear sample at ``py`` with zero padding.

In both, corners outside the image read 0 and each sample is scaled by the
mask and by ``valid = (py > -1) & (py < H) & (px > -1) & (px < W)``, taken
on the unclamped position. Offsets are y/x interleaved per tap; the mask is
already sigmoid-activated by the caller. Sampling and the contraction with
the weight accumulate in float32; the output has x's type.

The backward follows the JAX package's `_mdcv2_bwd` (the custom VJP of its
windowed kernels): the offset gradient is the derivative through the
bilinear fractions times the clip-pass indicator (1 where the windowed
fraction was not clipped; always 1 for exact), the mask gradient is taken
times `valid`, the floors carry no gradient, and the tap gradient and the
recomputed samples are rounded to x's type before their contractions.
"""
from __future__ import annotations

import torch

SEMANTICS = ("windowed", "exact")


def check_semantics(sem: str) -> str:
    if sem not in SEMANTICS:
        raise ValueError(f"unknown deform semantics {sem!r}; expected one of "
                         f"{SEMANTICS}")
    return sem


def _sample_fields(offset: torch.Tensor, mask: torch.Tensor, windowed: bool):
    """Per (pixel, tap) fields, each (B, P, 9): floors y0, x0 and fractions
    fy, fx; wv = mask * valid; the clip-pass indicators pass_y, pass_x and
    valid (float 0/1)."""
    B, H, W, _ = offset.shape
    P, K = H * W, 9
    f32 = torch.float32
    dev = offset.device
    gy, gx = torch.meshgrid(torch.arange(H, dtype=f32, device=dev) - 1,
                            torch.arange(W, dtype=f32, device=dev) - 1,
                            indexing="ij")
    tap = torch.arange(K, device=dev)
    ty, tx = (tap // 3).to(f32), (tap % 3).to(f32)
    off = offset.reshape(B, P, K, 2).to(f32)
    py = gy.reshape(1, P, 1) + ty + off[..., 0]
    px = gx.reshape(1, P, 1) + tx + off[..., 1]
    valid = ((py > -1.0) & (py < H) & (px > -1.0) & (px < W)).to(f32)
    if windowed:
        # the window of pixel i starts at row i - 3 = g - 2; r is the
        # window-relative position, its floor clamped per tap to [t, t + 4]
        def fr(o, t, g):
            r = t + o + 2.0
            r0 = torch.minimum(torch.maximum(torch.floor(r), t), t + 4.0)
            f = r - r0
            return (r0 + (g.reshape(1, P, 1) - 2.0), f.clamp(0.0, 1.0),
                    ((f >= 0.0) & (f <= 1.0)).to(f32))
        y0, fy, pass_y = fr(off[..., 0], ty, gy)
        x0, fx, pass_x = fr(off[..., 1], tx, gx)
    else:
        y0, x0 = torch.floor(py), torch.floor(px)
        fy, fx = py - y0, px - x0
        pass_y = pass_x = torch.ones_like(py)
    wv = mask.reshape(B, P, K).to(f32) * valid
    return y0, fy, x0, fx, wv, pass_y, pass_x, valid


def _corners(y0, fy, x0, fx, H: int, W: int):
    """The four bilinear corners (dy, dx) of every (pixel, tap): yields
    (dy, dx, flat pixel index clamped into the image, in-image 0/1, ay, ax),
    with ay, ax the corner's weights along each axis."""
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + dy, x0 + dx
        inb = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)).float()
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
        yield dy, dx, idx, inb, (fy if dy else 1.0 - fy), (fx if dx else 1.0 - fx)


def modulated_deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                                  mask: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor | None = None,
                                  semantics: str = "windowed") -> torch.Tensor:
    """DCNv2 forward, the kernel's plain version.

    x (B, H, W, Cin); offset (B, H, W, 18); mask (B, H, W, 9);
    weight (3, 3, Cin, Cout) HWIO; bias (Cout,) or None. Returns
    (B, H, W, Cout) in x's type.
    """
    windowed = check_semantics(semantics) == "windowed"
    B, H, W, Cin = x.shape
    if tuple(weight.shape[:2]) != (3, 3):
        raise ValueError(f"DCNv2 takes a 3x3 kernel, got {tuple(weight.shape)}")
    Cout = weight.shape[3]
    P, K = H * W, 9
    y0, fy, x0, fx, wv = _sample_fields(offset, mask, windowed)[:5]
    xf = x.reshape(B, H * W, Cin).float()
    sampled = torch.zeros(B, P * K, Cin, dtype=torch.float32, device=x.device)
    for _, _, idx, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        g = torch.gather(xf, 1, idx.reshape(B, P * K, 1).expand(-1, -1, Cin))
        sampled += g * (ay * ax * wv * inb).reshape(B, P * K, 1)
    out = sampled.reshape(B, P, K * Cin) @ weight.reshape(K * Cin, Cout).float()
    if bias is not None:
        out = out + bias.float()
    return out.reshape(B, H, W, Cout).to(x.dtype)


def modulated_deform_conv2d_plain_bwd(x: torch.Tensor, offset: torch.Tensor,
                                      mask: torch.Tensor, weight: torch.Tensor,
                                      grad_out: torch.Tensor,
                                      semantics: str = "windowed"):
    """DCNv2 backward (no bias), the backward kernel's plain version, written
    out with gathers and `index_add_` in the kernel's structure.

    x, offset, mask, weight as for the forward, all in x's type; grad_out
    (B, H, W, Cout). Returns (dx, d offset, d mask, d weight), each in its
    input's type; everything accumulates in float32.
    """
    windowed = check_semantics(semantics) == "windowed"
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    P, K = H * W, 9
    y0, fy, x0, fx, wv, pass_y, pass_x, valid = _sample_fields(offset, mask, windowed)
    g = grad_out.reshape(B * P, Cout).float()
    # tap gradient, rounded to x's type as the JAX glue rounds it
    ds = (g @ weight.reshape(K * Cin, Cout).float().T).to(x.dtype).float()
    ds = ds.reshape(B, P * K, Cin)
    xf = x.reshape(B, P, Cin).float()
    sampled = torch.zeros(B, P * K, Cin, dtype=torch.float32, device=x.device)
    dxf = torch.zeros(B * P, Cin, dtype=torch.float32, device=x.device)
    dfy = torch.zeros(B, P, K, dtype=torch.float32, device=x.device)
    dfx, dwv = torch.zeros_like(dfy), torch.zeros_like(dfy)
    base = (torch.arange(B, device=x.device) * P).reshape(B, 1, 1)
    for dy, dx, idx, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        xq = torch.gather(xf, 1, idx.reshape(B, P * K, 1).expand(-1, -1, Cin))
        xq = xq * inb.reshape(B, P * K, 1)
        wq = (ay * ax * wv * inb).reshape(B, P * K, 1)
        sampled += xq * wq
        dxf.index_add_(0, (idx + base).reshape(-1), (ds * wq).reshape(-1, Cin))
        dw_q = (ds * xq).sum(-1).reshape(B, P, K)
        dfy += dw_q * ax * wv * (1.0 if dy else -1.0)
        dfx += dw_q * ay * wv * (1.0 if dx else -1.0)
        dwv += dw_q * ay * ax
    sampled = sampled.to(x.dtype).float().reshape(B * P, K * Cin)
    dweight = (sampled.T @ g).reshape(weight.shape).to(weight.dtype)
    doffset = torch.stack([dfy * pass_y, dfx * pass_x], dim=-1)
    return (dxf.reshape(x.shape).to(x.dtype), doffset.reshape(offset.shape).to(offset.dtype),
            (dwv * valid).reshape(mask.shape).to(mask.dtype), dweight)
