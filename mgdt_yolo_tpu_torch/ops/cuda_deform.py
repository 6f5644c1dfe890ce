"""Wrappers of the hand-written DCNv2 kernels and `deform_conv`, the model's
one entry to DCNv2: the registered operator `mgdt::deform_fwd`, whose
autograd formula is the operator `mgdt::deform_bwd`.

* `deform_fwd` (K1, `csrc/deform_fwd.cu`) and `deform_bwd` (K2,
  `csrc/deform_bwd.cu`): the Hopper designs the main path runs. K1 contracts
  each tap's samples with the weight on the tensor cores (`mma.sync`, bf16
  hi/lo terms of the float32 samples), fed by double-buffered `cp.async`
  corner gathers, in persistent blocks that hold the weight; K2 takes both
  contractions with the weight on the tensor cores and accumulates dx in a
  shared-memory window of its tile's rows, which the windowed reach (every
  corner of output (i, j) lies in rows [i - 3, i + 4] and columns
  [j - 3, j + 4]) keeps small; corners outside it (exact semantics) go to
  global atomics. Where the 9 taps' weight does not fit in a block's shared
  memory (K1 above C 64, or float32 at C 64; K2 in float32 from C 64 and in
  bf16 above it) each kernel takes a second plan that stages the weight one
  tap at a time (`plan` says which runs). Square C up to 172 (float32) and
  256 (bf16) for K1, 144 (float32) and 194 (bf16) for K2 at any map width
  fits a plan; `_shape_smem` raises above that.
* `deform_fwd_simt` and `deform_bwd_simt` (`csrc/deform_{fwd,bwd}_simt.cu`):
  the first designs, contracting on the CUDA cores, kept as the A/B
  baseline of the two and, for the forward, as the float32 order that the
  K1 variants (`ops/cuda_deform_variants.py`) are held to bit for bit. No
  path of the model reaches them.

For CUDA tensors each wrapper launches its kernel on the current stream;
a CPU tensor goes to the plain versions in `ops/deform.py`
(`modulated_deform_conv2d_plain` and `modulated_deform_conv2d_plain_bwd`)
without counting a launch. Any other input a kernel does not take raises
(for K1 and K2 also a channel count whose tile does not fit in a block's
shared memory), and nothing falls back. `launches`, `bwd_launches`,
`simt_launches` and `bwd_simt_launches` count the four kernels' launches,
so a run can show which kernels its path went through.

`deform_fwd_op` and `deform_bwd_op` register K1 and K2 with
`torch.library.custom_op` (fake implementations give their shapes), so that
`torch.export` keeps K1 as one node of the exported program, which then
launches K1 on the card and runs the plain version on the CPU, as the
wrappers do.
"""
from __future__ import annotations

import ctypes

import torch

from .deform import (check_semantics, modulated_deform_conv2d_plain,
                     modulated_deform_conv2d_plain_bwd)

# launches of each kernel since its count was last set to 0
launches = 0            # deform_fwd (K1)
bwd_launches = 0        # deform_bwd (K2)
simt_launches = 0       # deform_fwd_simt
bwd_simt_launches = 0   # deform_bwd_simt

# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def _library(name: str, n_ptrs: int, source: str | None = None,
             smem_args: int = 2, has_plan: bool = False) -> ctypes.CDLL:
    """Build (first use) and load the library of `csrc/<source>.cu` (default:
    `name`), with the C signatures of kernel `name`: `name(n_ptrs pointers,
    B, H, W, Cin, Cout, windowed, bf16, stream)`, `name_smem_bytes` of
    `smem_args` ints and, with `has_plan`, `name_plan` of the same ints."""
    from ..utils.build import load_library
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    plan = ((f"{name}_plan", ctypes.c_longlong, (i32,) * smem_args),) if has_plan else ()
    return load_library(source or name, (
        (name, i32, (ptr,) * n_ptrs + (i32,) * 7 + (ptr,)),
        (f"{name}_smem_bytes", ctypes.c_longlong, (i32,) * smem_args), *plan))


# each kernel: (its pointer count, the arguments of its `_smem_bytes`)
_KERNELS = {"deform_fwd": (6, ("Cin", "Cout", "bf16")),
            "deform_fwd_simt": (6, ("Cin", "Cout")),
            "deform_bwd": (9, ("W", "Cin", "Cout", "bf16")),
            "deform_bwd_simt": (9, ("Cin", "Cout"))}


# the kernels with two plans (the 9 taps' weight resident, or staged by tap)
_PLANNED = ("deform_fwd", "deform_bwd")


def _kernel_lib(kernel: str) -> ctypes.CDLL:
    n_ptrs, names = _KERNELS[kernel]
    return _library(kernel, n_ptrs, smem_args=len(names), has_plan=kernel in _PLANNED)


def _kernel_smem(kernel: str, **shape) -> int:
    """The shared memory one block of `kernel` needs (-1: no tile fits), from
    the named sizes of `shape` that the kernel's plan depends on."""
    names = _KERNELS[kernel][1]
    return getattr(_kernel_lib(kernel), f"{kernel}_smem_bytes")(
        *(int(shape[n]) for n in names))


def plan(kernel: str, **shape) -> str:
    """Which plan K1 ("deform_fwd": Cin, Cout, bf16) or K2 ("deform_bwd": W,
    Cin, Cout, bf16) takes at `shape`: "resident" (the 9 taps' weight in
    shared memory), "streamed" (staged one tap at a time) or "none"."""
    names = _KERNELS[kernel][1]
    got = getattr(_kernel_lib(kernel), f"{kernel}_plan")(*(int(shape[n]) for n in names))
    return {0: "resident", 1: "streamed"}.get(got, "none")


def simt_smem_bytes(Cin: int, Cout: int) -> int:
    """The shared memory one block of the SIMT forward kernel needs."""
    return _kernel_smem("deform_fwd_simt", Cin=Cin, Cout=Cout)


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


def _shape_smem(kernel: str, Cin: int, Cout: int, **shape) -> None:
    """Raise where `kernel` does not take these channel counts: no tile of
    it fits in the shared memory a block may use (K2's tile also depends on
    the map's width)."""
    smem = _kernel_smem(kernel, Cin=Cin, Cout=Cout, **shape)
    if smem < 0 or smem > _MAX_SMEM:
        need = "no tile fits" if smem < 0 else f"a block needs {smem} B"
        raise ValueError(f"{kernel} does not take Cin={Cin}, Cout={Cout} ({shape}): {need} "
                         f"in the {_MAX_SMEM} B of shared memory a block may use")


def _fwd(kernel: str, counter: str, x, offset, mask, weight, bias, semantics):
    windowed = check_semantics(semantics) == "windowed"
    if x.device.type == "cpu":
        return modulated_deform_conv2d_plain(x, offset, mask, weight, bias,
                                             semantics)
    if not x.is_cuda:
        raise ValueError(f"{kernel} takes CUDA or CPU tensors, got {x.device}")
    B, H, W, Cin, Cout = _check(x, offset, mask, weight, bias)
    _shape_smem(kernel, Cin, Cout, W=W, bf16=x.dtype == torch.bfloat16)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch = getattr(_kernel_lib(kernel), kernel)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                     None if bias is None else bias.data_ptr(), out.data_ptr(),
                     B, H, W, Cin, Cout, int(windowed), int(x.dtype == torch.bfloat16),
                     stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    globals()[counter] += 1
    return out


def deform_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor | None = None,
               semantics: str = "windowed") -> torch.Tensor:
    """DCNv2 forward (3x3, stride 1, padding 1), NHWC in and out, by K1.

    x (B, H, W, Cin); offset (B, H, W, 18) y/x per tap; mask (B, H, W, 9);
    weight (3, 3, Cin, Cout) in x's type; bias float32 (Cout,) or None.
    Takes Cin = Cout up to 172 in float32 and 256 in bf16 (other pairs:
    where `deform_fwd_smem_bytes` finds a plan) and raises above.
    """
    return _fwd("deform_fwd", "launches", x, offset, mask, weight, bias, semantics)


def deform_fwd_simt(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor | None = None,
                    semantics: str = "windowed") -> torch.Tensor:
    """`deform_fwd` by the SIMT kernel, the A/B baseline of K1."""
    return _fwd("deform_fwd_simt", "simt_launches", x, offset, mask, weight, bias,
                semantics)


def _bwd(kernel: str, counter: str, x, offset, mask, weight, grad_out, semantics):
    windowed = check_semantics(semantics) == "windowed"
    if x.device.type == "cpu":
        return modulated_deform_conv2d_plain_bwd(x, offset, mask, weight, grad_out,
                                                 semantics)
    if not x.is_cuda:
        raise ValueError(f"{kernel} takes CUDA or CPU tensors, got {x.device}")
    B, H, W, Cin, Cout = _check(x, offset, mask, weight, None)
    if tuple(grad_out.shape) != (B, H, W, Cout):
        raise ValueError(f"grad_out must be {(B, H, W, Cout)}, got {tuple(grad_out.shape)}")
    if grad_out.device != x.device or grad_out.dtype != x.dtype:
        raise TypeError(f"grad_out is {grad_out.dtype} on {grad_out.device}, "
                        f"x {x.dtype} on {x.device}")
    if not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous")
    _shape_smem(kernel, Cin, Cout, W=W, bf16=x.dtype == torch.bfloat16)
    f32 = torch.float32
    dx = torch.zeros((B, H, W, Cin), dtype=f32, device=x.device)
    dweight = torch.zeros(weight.shape, dtype=f32, device=x.device)
    doffset, dmask = torch.empty_like(offset), torch.empty_like(mask)
    if x.numel() == 0:
        return dx.to(x.dtype), doffset, dmask, dweight.to(weight.dtype)
    launch = getattr(_kernel_lib(kernel), kernel)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                     grad_out.data_ptr(), dx.data_ptr(), doffset.data_ptr(),
                     dmask.data_ptr(), dweight.data_ptr(), B, H, W, Cin, Cout,
                     int(windowed), int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    globals()[counter] += 1
    return dx.to(x.dtype), doffset, dmask, dweight.to(weight.dtype)


def deform_bwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, grad_out: torch.Tensor,
               semantics: str = "windowed"):
    """DCNv2 backward (3x3, stride 1, padding 1, no bias), NHWC, by K2.

    x, offset, mask, weight as for `deform_fwd`; grad_out (B, H, W, Cout) in
    x's type. Returns (dx, d offset, d mask, d weight) in the inputs' type.
    Takes Cin = Cout up to 144 in float32 and 194 in bf16 at any map width
    (other shapes: where `deform_bwd_smem_bytes` finds a plan) and raises
    above.
    """
    return _bwd("deform_bwd", "bwd_launches", x, offset, mask, weight, grad_out, semantics)


def deform_bwd_simt(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                    weight: torch.Tensor, grad_out: torch.Tensor,
                    semantics: str = "windowed"):
    """`deform_bwd` by the SIMT kernel, the A/B baseline of K2."""
    return _bwd("deform_bwd_simt", "bwd_simt_launches", x, offset, mask, weight, grad_out,
                semantics)


# K1 and K2 as PyTorch operators, so that a traced program (`torch.export`)
# holds K1 as one opaque node whatever device it was traced on, and runs it
# by the device of the tensors it is given: the kernel on the card, the
# plain version on the CPU, through the wrappers above (which count the
# launches; the wrappers are looked up when the operator runs).
@torch.library.custom_op("mgdt::deform_fwd", mutates_args=())
def deform_fwd_op(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, semantics: str) -> torch.Tensor:
    """`deform_fwd` without a bias, as the registered operator."""
    return deform_fwd(x, offset, mask, weight, None, semantics)


@deform_fwd_op.register_fake
def _(x, offset, mask, weight, semantics):
    return x.new_empty((*x.shape[:3], weight.shape[3]))


@torch.library.custom_op("mgdt::deform_bwd", mutates_args=())
def deform_bwd_op(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, grad_out: torch.Tensor,
                  semantics: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`deform_bwd` as the registered operator."""
    return tuple(deform_bwd(x, offset, mask, weight, grad_out, semantics))


@deform_bwd_op.register_fake
def _(x, offset, mask, weight, grad_out, semantics):
    return (torch.empty_like(x), torch.empty_like(offset), torch.empty_like(mask),
            torch.empty_like(weight))


def _setup_context(ctx, inputs, output):
    x, offset, mask, weight, semantics = inputs
    ctx.semantics = semantics
    ctx.save_for_backward(x, offset, mask, weight)


def _backward(ctx, grad_out):
    """K2 on the saved x, offset, mask and weight, as the JAX custom VJP."""
    x, offset, mask, weight = ctx.saved_tensors
    grads = deform_bwd_op(x, offset, mask, weight, grad_out.contiguous(), ctx.semantics)
    return (*grads, None)


deform_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """Differentiable DCNv2, NHWC: offset, mask and weight are cast to x's
    type first (the JAX module casts its weight to the compute type), so the
    kernels see one type and the casts' own backward restores the
    parameters' type."""
    dt = x.dtype
    return deform_fwd_op(x.contiguous(), offset.to(dt).contiguous(),
                         mask.to(dt).contiguous(), weight.to(dt).contiguous(),
                         check_semantics(semantics))
