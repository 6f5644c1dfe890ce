"""Wrappers of the five K1 variants, hand-written CUDA kernels of the DCNv2
forward in `csrc/deform_fwd_variants.cu`, each the Hopper counterpart of one
TPU prototype (the repo-root `tools/proto_deform_*.py`):

* `deform_fwd_bf16_fma` (V1): bf16 corner weights and bf16 products;
* `deform_qxhoist` (V2): the input slab staged once in shared memory;
* `deform_cvt1` (V3): V2 with the slab converted to float32 once;
* `deform_fwd_slot_skip` (V4): zero-weight corners and dead taps skipped;
* `deform_fwd_tapwalk` (V5): the contraction walked tap by tap.

They take the JAX tools' signatures (NHWC x, offset, mask, weight; `bias`
for V2 and V3) and windowed semantics only. For CUDA tensors each launches
its kernel on the current stream; a CPU tensor goes to its plain version
(`ops/deform_variants.py`: V1's own, K1's windowed plain version for V2-V5)
without counting a launch. Any other input the kernels do not take raises:
exact semantics, more shared memory than a block may use, a non-contiguous
or mistyped tensor (K1's checks, `cuda_deform._check`), and for V1 in bf16
an odd Cin or an x not aligned to 4 bytes (it reads channel pairs). Nothing
falls back. `launches` counts each kernel's launches, keyed by its C entry
point; `smem_bytes` gives the shared memory one block of a kernel needs.
"""
from __future__ import annotations

import torch

from .cuda_deform import _MAX_SMEM, _check, _library
from .deform import check_semantics
from .deform_variants import deform_bf16_fma_plain, windowed_plain

SOURCE = "deform_fwd_variants"      # csrc/deform_fwd_variants.cu

# launches of each variant's kernel since its count was last set to 0
launches = dict.fromkeys(("deform_fwd_bf16_fma", "deform_fwd_qxhoist", "deform_fwd_cvt1",
                          "deform_fwd_slot_skip", "deform_fwd_tapwalk"), 0)


def smem_bytes(kernel: str, W: int, Cin: int, Cout: int, dtype: torch.dtype) -> int:
    """The shared memory one block of `kernel` needs at width W, Cin, Cout
    in `dtype`; -1 where the kernel does not take the channel counts."""
    lib = _library(kernel, 6, source=SOURCE, smem_args=4)
    return getattr(lib, f"{kernel}_smem_bytes")(W, Cin, Cout, int(dtype == torch.bfloat16))


def _run(kernel, plain, x, offset, mask, weight, bias, semantics):
    if check_semantics(semantics) != "windowed":
        raise ValueError(f"{kernel} computes windowed semantics only, got {semantics!r}")
    if x.device.type == "cpu":
        return plain()
    if not x.is_cuda:
        raise ValueError(f"{kernel} takes CUDA or CPU tensors, got {x.device}")
    B, H, W, Cin, Cout = _check(x, offset, mask, weight, bias)
    smem = smem_bytes(kernel, W, Cin, Cout, x.dtype)
    if smem < 0:
        raise ValueError(f"{kernel} does not take Cin={Cin}, Cout={Cout}")
    if smem > _MAX_SMEM:
        raise ValueError(f"{kernel} at W={W}, Cin={Cin}, Cout={Cout}, {x.dtype} needs "
                         f"{smem} B of shared memory per block, more than {_MAX_SMEM}")
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch = getattr(_library(kernel, 6, source=SOURCE, smem_args=4), kernel)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                     None if bias is None else bias.data_ptr(), out.data_ptr(),
                     B, H, W, Cin, Cout, 1, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launches[kernel] += 1
    return out


def deform_fwd_bf16_fma(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                        weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """V1: corner weights rounded to bf16, corner products in x's type,
    float32 sums (`deform_bf16_fma_plain` is its function). No bias. In bf16
    it reads x's channels in pairs: Cin even (its `smem_bytes` is -1 for an
    odd one) and x aligned to 4 bytes."""
    if x.is_cuda and x.dtype == torch.bfloat16 and x.data_ptr() % 4:
        raise ValueError("deform_fwd_bf16_fma reads bf16 channel pairs: x must be aligned "
                         "to 4 bytes")
    return _run("deform_fwd_bf16_fma",
                lambda: deform_bf16_fma_plain(x, offset, mask, weight),
                x, offset, mask, weight, None, semantics)


def deform_qxhoist(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor | None = None,
                   semantics: str = "windowed") -> torch.Tensor:
    """V2: K1's function from an input slab staged once per block in x's
    type. bias float32 (Cout,) or None."""
    return _run("deform_fwd_qxhoist",
                lambda: windowed_plain(x, offset, mask, weight, bias),
                x, offset, mask, weight, bias, semantics)


def deform_cvt1(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor | None = None,
                semantics: str = "windowed") -> torch.Tensor:
    """V3: V2 with the slab converted to float32 once, at staging."""
    return _run("deform_fwd_cvt1",
                lambda: windowed_plain(x, offset, mask, weight, bias),
                x, offset, mask, weight, bias, semantics)


def deform_fwd_slot_skip(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                         weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """V4: K1 with zero-weight corners and dead (pixel, tap) pairs skipped;
    K1's bits on finite inputs."""
    return _run("deform_fwd_slot_skip",
                lambda: windowed_plain(x, offset, mask, weight),
                x, offset, mask, weight, None, semantics)


def deform_fwd_tapwalk(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                       weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """V5: K1's function contracted tap by tap (Cout <= 128)."""
    return _run("deform_fwd_tapwalk",
                lambda: windowed_plain(x, offset, mask, weight),
                x, offset, mask, weight, None, semantics)


# each variant's wrapper and plain version, keyed by its kernel's name
VARIANTS = {"deform_fwd_bf16_fma": (deform_fwd_bf16_fma, deform_bf16_fma_plain),
            "deform_fwd_qxhoist": (deform_qxhoist, windowed_plain),
            "deform_fwd_cvt1": (deform_cvt1, windowed_plain),
            "deform_fwd_slot_skip": (deform_fwd_slot_skip, windowed_plain),
            "deform_fwd_tapwalk": (deform_fwd_tapwalk, windowed_plain)}
