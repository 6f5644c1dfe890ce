"""Wrappers of the hand-written DCNv2 kernels, forward (`csrc/deform_fwd.cu`)
and backward (`csrc/deform_bwd.cu`), and `deform_conv`, the model's one entry
to DCNv2: a `torch.autograd.Function` that pairs the two.

`deform_fwd` and `deform_bwd` launch their kernels on the current stream for
CUDA tensors. A CPU tensor goes to the plain versions in `ops/deform.py`
(`modulated_deform_conv2d_plain` and `modulated_deform_conv2d_plain_bwd`);
any other input the kernels do not take raises, and no failure falls back.
`launches` and `bwd_launches` count the two kernels' launches, so a run can
show that its path went through them.
"""
from __future__ import annotations

import ctypes

import torch

from .deform import (check_semantics, modulated_deform_conv2d_plain,
                     modulated_deform_conv2d_plain_bwd)

# launches of each kernel since its count was last set to 0
launches = 0        # deform_fwd
bwd_launches = 0    # deform_bwd

# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def _library(name: str, n_ptrs: int) -> ctypes.CDLL:
    """Build (first use) and load the library of kernel `name`, with its C
    signatures: `name(n_ptrs pointers, B, H, W, Cin, Cout, windowed, bf16,
    stream)` and `name_smem_bytes(Cin, Cout)`."""
    from ..utils.build import load_library
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return load_library(name, (
        (name, i32, (ptr,) * n_ptrs + (i32,) * 7 + (ptr,)),
        (f"{name}_smem_bytes", ctypes.c_longlong, (i32, i32))))


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
    lib = _library("deform_fwd", 6)
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


def deform_bwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, grad_out: torch.Tensor,
               semantics: str = "windowed"):
    """DCNv2 backward (3x3, stride 1, padding 1, no bias), NHWC.

    x, offset, mask, weight as for `deform_fwd`; grad_out (B, H, W, Cout) in
    x's type. Returns (dx, d offset, d mask, d weight) in the inputs' type.
    """
    global bwd_launches
    windowed = check_semantics(semantics) == "windowed"
    if x.device.type == "cpu":
        return modulated_deform_conv2d_plain_bwd(x, offset, mask, weight, grad_out,
                                                 semantics)
    if not x.is_cuda:
        raise ValueError(f"deform_bwd takes CUDA or CPU tensors, got {x.device}")
    B, H, W, Cin, Cout = _check(x, offset, mask, weight, None)
    if tuple(grad_out.shape) != (B, H, W, Cout):
        raise ValueError(f"grad_out must be {(B, H, W, Cout)}, got {tuple(grad_out.shape)}")
    if grad_out.device != x.device or grad_out.dtype != x.dtype:
        raise TypeError(f"grad_out is {grad_out.dtype} on {grad_out.device}, "
                        f"x {x.dtype} on {x.device}")
    if not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous")
    lib = _library("deform_bwd", 9)
    smem = lib.deform_bwd_smem_bytes(Cin, Cout)
    if smem > _MAX_SMEM:
        raise ValueError(f"Cin={Cin}, Cout={Cout} needs {smem} B of shared "
                         f"memory per block, more than {_MAX_SMEM}")
    f32 = torch.float32
    dx = torch.zeros((B, H, W, Cin), dtype=f32, device=x.device)
    dweight = torch.zeros(weight.shape, dtype=f32, device=x.device)
    doffset, dmask = torch.empty_like(offset), torch.empty_like(mask)
    if x.numel() == 0:
        return dx.to(x.dtype), doffset, dmask, dweight.to(weight.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.deform_bwd(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                             weight.data_ptr(), grad_out.data_ptr(), dx.data_ptr(),
                             doffset.data_ptr(), dmask.data_ptr(), dweight.data_ptr(),
                             B, H, W, Cin, Cout, int(windowed),
                             int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"deform_bwd kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx.to(x.dtype), doffset, dmask, dweight.to(weight.dtype)


class DeformConv(torch.autograd.Function):
    """DCNv2 (no bias) with K1 as its forward and K2 as its backward; saves
    x, offset, mask and weight, as the JAX custom VJP does. Under autocast
    the backward runs in the forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, offset, mask, weight, semantics):
        ctx.semantics = semantics
        ctx.save_for_backward(x, offset, mask, weight)
        return deform_fwd(x, offset, mask, weight, None, semantics)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        grads = deform_bwd(x, offset, mask, weight, grad_out.contiguous(), ctx.semantics)
        return (*grads, None)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """Differentiable DCNv2, NHWC: offset, mask and weight are cast to x's
    type first (the JAX module casts its weight to the compute type), so the
    kernels see one type and the casts' own backward restores the
    parameters' type."""
    dt = x.dtype
    return DeformConv.apply(x.contiguous(), offset.to(dt).contiguous(),
                            mask.to(dt).contiguous(), weight.to(dt).contiguous(),
                            check_semantics(semantics))
