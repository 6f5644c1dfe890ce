"""Wrapper of K3, the hand-written flip + HSV + normalise kernel
(`csrc/fused_augment.cu`).

`fused_augment` launches the kernel on the current stream for CUDA tensors;
a CPU tensor goes to the plain version `ops/image.fused_augment_plain`. Any
other input the kernel does not take raises, and no failure falls back.
`launches` counts the kernel's launches, so a run can show that its path
went through it.
"""
from __future__ import annotations

import ctypes

import torch

from .image import fused_augment_plain

launches = 0   # fused_augment launches since the count was last set to 0


def _library() -> ctypes.CDLL:
    """Build (first use) and load K3's library with its C signature
    `fused_augment(images, gains, flips, out, B, H, W, stream)`."""
    from ..utils.build import load_library
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return load_library("fused_augment", (
        ("fused_augment", i32, (ptr,) * 4 + (i32,) * 3 + (ptr,)),))


def fused_augment(images_u8: torch.Tensor, hsv_gains: torch.Tensor,
                  flips: torch.Tensor) -> torch.Tensor:
    """Flip, HSV-adjust and normalise a batch: images (B, H, W, 3) uint8
    RGB, hsv_gains (B, 3) float32 h/s/v gains (1 = identity), flips (B, 2)
    int [left-right, up-down]. Returns (B, H, W, 3) float32 in [0, 1]."""
    global launches
    if images_u8.device.type == "cpu":
        return fused_augment_plain(images_u8, hsv_gains, flips)
    if not images_u8.is_cuda:
        raise ValueError(f"fused_augment takes CUDA or CPU tensors, got {images_u8.device}")
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
    lib = _library()
    with torch.cuda.device(images_u8.device):
        stream = torch.cuda.current_stream(images_u8.device).cuda_stream
        err = lib.fused_augment(images_u8.data_ptr(), hsv_gains.data_ptr(), flips.data_ptr(),
                                out.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"fused_augment kernel launch failed: CUDA error {err}")
    launches += 1
    return out
