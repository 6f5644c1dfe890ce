"""Wrappers of K3, the hand-written flip + HSV + normalise kernel.

* `fused_augment` (`csrc/fused_augment.cu`): the Hopper design the
  augmented path runs: 4 output pixels a thread from aligned 32-bit loads,
  contiguous float4 stores through a per-warp stage, a (row group, image)
  grid, /255 from a shared-memory table and the other divisions and
  floor-mods in division-free forms that give the same bits.
* `fused_augment_simt` (`csrc/fused_augment_simt.cu`): the first design,
  one thread per pixel, kept as the A/B baseline and the bitwise reference
  of the Hopper design. No path of the trainer reaches it.

For CUDA tensors each wrapper launches its kernel on the current stream; a
CPU tensor goes to the plain version `ops/image.fused_augment_plain`
without counting a launch. Any other input the kernels do not take raises,
and no failure falls back. `launches` and `simt_launches` count the two
kernels' launches, so a run can show which kernel its path went through.
"""
from __future__ import annotations

import ctypes

import torch

from .image import fused_augment_plain

launches = 0        # fused_augment launches since the count was last set to 0
simt_launches = 0   # fused_augment_simt launches


def _library(name: str) -> ctypes.CDLL:
    """Build (first use) and load `csrc/<name>.cu` with its C signature
    `name(images, gains, flips, out, B, H, W, stream)`."""
    from ..utils.build import load_library
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return load_library(name, ((name, i32, (ptr,) * 4 + (i32,) * 3 + (ptr,)),))


def _augment(kernel: str, counter: str, images_u8: torch.Tensor, hsv_gains: torch.Tensor,
             flips: torch.Tensor) -> torch.Tensor:
    if images_u8.device.type == "cpu":
        return fused_augment_plain(images_u8, hsv_gains, flips)
    if not images_u8.is_cuda:
        raise ValueError(f"{kernel} takes CUDA or CPU tensors, got {images_u8.device}")
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3) uint8, got {tuple(images_u8.shape)} "
                         f"{images_u8.dtype}")
    B, H, W, _ = images_u8.shape
    for name, t, shape, dtype in (("hsv_gains", hsv_gains, (B, 3), torch.float32),
                                  ("flips", flips, (B, 2), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != images_u8.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {images_u8.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not images_u8.is_contiguous():
        raise ValueError("images must be contiguous")
    out = torch.empty((B, H, W, 3), dtype=torch.float32, device=images_u8.device)
    if out.numel() == 0:
        return out
    launch = getattr(_library(kernel), kernel)
    with torch.cuda.device(images_u8.device):
        stream = torch.cuda.current_stream(images_u8.device).cuda_stream
        err = launch(images_u8.data_ptr(), hsv_gains.data_ptr(), flips.data_ptr(),
                     out.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    globals()[counter] += 1
    return out


def fused_augment(images_u8: torch.Tensor, hsv_gains: torch.Tensor,
                  flips: torch.Tensor) -> torch.Tensor:
    """Flip, HSV-adjust and normalise a batch by K3: images (B, H, W, 3)
    uint8 RGB, hsv_gains (B, 3) float32 h/s/v gains (1 = identity), flips
    (B, 2) int32 [left-right, up-down]. Returns (B, H, W, 3) float32 in
    [0, 1]."""
    return _augment("fused_augment", "launches", images_u8, hsv_gains, flips)


def fused_augment_simt(images_u8: torch.Tensor, hsv_gains: torch.Tensor,
                       flips: torch.Tensor) -> torch.Tensor:
    """`fused_augment` by the SIMT kernel, the A/B baseline of K3."""
    return _augment("fused_augment_simt", "simt_launches", images_u8, hsv_gains, flips)
