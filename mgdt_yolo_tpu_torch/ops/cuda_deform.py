"""Wrapper of the hand-written DCNv2 forward kernel (`csrc/deform_fwd.cu`),
the model's one entry to DCNv2.

`deform_fwd` launches the kernel on the current stream for CUDA tensors. A
CPU tensor goes to the plain version (`ops.deform.modulated_deform_conv2d_plain`);
any other input the kernel does not take raises, and no failure falls back.
`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .deform import check_semantics, modulated_deform_conv2d_plain

# launches of the kernel since the count was last set to 0
launches = 0

# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C signatures."""
    from ..utils.build import load_library
    lib = load_library("deform_fwd")
    lib.deform_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.deform_fwd.restype = ctypes.c_int
    lib.deform_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.deform_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(x, offset, mask, weight, bias):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"deform_fwd takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    B, H, W, Cin = x.shape
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, Cin):
        raise ValueError(f"weight must be (3, 3, {Cin}, Cout), got "
                         f"{tuple(weight.shape)}")
    Cout = weight.shape[3]
    for name, t, shape in (("offset", offset, (B, H, W, 18)),
                           ("mask", mask, (B, H, W, 9))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("offset", offset), ("mask", mask),
                    ("weight", weight)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias is not None:
        if tuple(bias.shape) != (Cout,) or bias.device != x.device:
            raise ValueError(f"bias must be ({Cout},) on {x.device}")
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            raise TypeError("bias must be a contiguous float32 tensor")
    return B, H, W, Cin, Cout


def deform_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor | None = None,
               semantics: str = "windowed") -> torch.Tensor:
    """DCNv2 forward (3x3, stride 1, padding 1), NHWC in and out.

    x (B, H, W, Cin); offset (B, H, W, 18) y/x per tap; mask (B, H, W, 9);
    weight (3, 3, Cin, Cout) in x's type; bias float32 (Cout,) or None.
    """
    global launches
    windowed = check_semantics(semantics) == "windowed"
    if x.device.type == "cpu":
        return modulated_deform_conv2d_plain(x, offset, mask, weight, bias,
                                             semantics)
    if not x.is_cuda:
        raise ValueError(f"deform_fwd takes CUDA or CPU tensors, got {x.device}")
    B, H, W, Cin, Cout = _check(x, offset, mask, weight, bias)
    lib = _library()
    smem = lib.deform_fwd_smem_bytes(Cin, Cout)
    if smem > _MAX_SMEM:
        raise ValueError(f"Cin={Cin}, Cout={Cout} needs {smem} B of shared "
                         f"memory per block, more than {_MAX_SMEM}")
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.deform_fwd(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                             weight.data_ptr(),
                             None if bias is None else bias.data_ptr(),
                             out.data_ptr(), B, H, W, Cin, Cout, int(windowed),
                             int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"deform_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out
