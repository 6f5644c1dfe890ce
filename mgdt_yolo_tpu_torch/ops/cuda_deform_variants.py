"""Wrappers of the K1 variants, hand-written CUDA kernels of the DCNv2
forward, each the Hopper counterpart of one TPU prototype (the repo-root
`tools/proto_deform_*.py`):

* `deform_fwd_bf16_fma` (V1): bf16 corner weights and bf16 products;
* `deform_qxhoist` (V2): the input rows staged once per block in shared
  memory, in x's type;
* `deform_cvt1` (V3): V2 with the staged rows converted to float32 once;
* `deform_fwd_slot_skip` (V4): zero-weight corners and dead taps skipped;
* `deform_fwd_tapwalk` (V5): the contraction walked tap by tap.

V1, V4 and V5 (`csrc/deform_fwd_variants.cu`) are designs on the CUDA cores
beside the SIMT K1. V2 and V3 (`csrc/deform_fwd_slab.cu`) are K1's
tensor-core design fed from a ring of input rows in shared memory, loaded
asynchronously; their plan (`slab_plan`: rows per band, ring rows, warps,
blocks, bytes) is chosen here and passed to the kernel, which refuses a plan
its own layout disagrees with. They give the Hopper K1's bits. Their first
designs, on the CUDA cores, stay in `csrc/deform_fwd_variants.cu` as their A/B
baseline: `deform_qxhoist_simt` and `deform_cvt1_simt`.

They take the JAX tools' signatures (NHWC x, offset, mask, weight; `bias`
for V2 and V3) and windowed semantics only. For CUDA tensors each launches
its kernel on the current stream; a CPU tensor goes to its plain version
(`ops/deform_variants.py`: V1's own, K1's windowed plain version for V2-V5)
without counting a launch. Any other input the kernels do not take raises:
exact semantics, more shared memory than a block may use (V2 and V3: no
slab plan fits, as at C 64), a non-contiguous or mistyped tensor (K1's
checks, `cuda_deform._check`), and for V1 in bf16 an odd Cin or an x not
aligned to 4 bytes (it reads channel pairs). Nothing falls back. `launches`
counts each kernel's launches, keyed by its C entry point; `smem_bytes`
gives the shared memory one block of a CUDA-core kernel needs.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_deform import _MAX_SMEM, _check, _library
from .deform import check_semantics
from .deform_variants import deform_bf16_fma_plain, windowed_plain

SOURCE = "deform_fwd_variants"      # csrc/deform_fwd_variants.cu: the CUDA-core designs
SLAB_SOURCE = "deform_fwd_slab"     # csrc/deform_fwd_slab.cu: the Hopper V2 and V3
SLAB_KERNELS = ("deform_fwd_qxhoist", "deform_fwd_cvt1")

# launches of each variant's kernel since its count was last set to 0
launches = dict.fromkeys(("deform_fwd_bf16_fma", "deform_fwd_qxhoist", "deform_fwd_cvt1",
                          "deform_fwd_slot_skip", "deform_fwd_tapwalk",
                          "deform_fwd_qxhoist_simt", "deform_fwd_cvt1_simt"), 0)

# The slab plan. Output rows per band, the largest that fits first: a band is
# one block barrier, and a run of bands reads x once plus 7 halo rows.
SLAB_ROWS = (8, 4, 2)
SLAB_MAX_WARPS = 16
# below this many warps a band (or all its items, if fewer) the plan is
# refused and the next RB is tried: the warps are what hides the latency
SLAB_MIN_WARPS = 8
_NTW = 4                   # n-tiles of 8 output channels per warp item, as K1
_SMEM_PER_SM = 233472      # an H100 SM's shared memory, which its blocks share
_REGS_PER_SM_WARPS = 16    # warps an SM holds at the kernel's 128 registers a thread


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def slab_layout(W: int, Cin: int, Cout: int, x_bytes: int, slab_bytes: int, rb: int,
                ring_rows: int, warps: int) -> dict:
    """The shared memory of one block of the Hopper V2/V3 (`layout` in
    `csrc/deform_fwd_slab.cu`, which the launch recomputes): K1's bf16
    weight (hi, and lo for float32), the ring of `ring_rows` input rows (W x
    Cin in the slab's type, padded to 16 bytes) and a zero row, V3's stage of
    `rb` raw rows where x is bf16, and per warp the (16, Cin) hi/lo samples
    (or the epilogue's (16, 36) float32 staging over them), two taps' corner
    fields and two items' offsets and mask (the next item's are fetched while
    this one is computed). Sizes in bytes."""
    CK = _round_up(Cin, 16)
    SA, NP = CK + 8, _round_up(Cout, 8)
    weight = 9 * NP * SA * 2 * (2 if x_bytes == 4 else 1)
    ring = ring_rows * _round_up(W * Cin * slab_bytes, 16) + _round_up(Cin * slab_bytes, 16)
    stage = rb * _round_up(W * Cin * x_bytes, 16) if x_bytes != slab_bytes else 0
    warp = max(2 * 16 * SA * 2, 16 * (_NTW * 8 + 4) * 4) + 2 * 2 * 16 * 4 * 4 + \
        2 * _round_up(16 * 27 * x_bytes, 16)
    return {"weight_bytes": weight, "ring_bytes": ring, "stage_bytes": stage,
            "warp_bytes": warp, "smem": weight + ring + stage + warps * warp}


def slab_plan(kernel: str, B: int, H: int, W: int, Cin: int, Cout: int,
              dtype: torch.dtype, sms: int) -> dict | None:
    """The plan of the Hopper V2 ("deform_fwd_qxhoist") or V3
    ("deform_fwd_cvt1") at x (B, H, W, Cin), Cout output channels, x's
    `dtype`, on a card of `sms` SMs; None where none fits in a block's
    shared memory.

    For each `rb` of SLAB_ROWS in turn: the ring holds a band's rb + 7 input
    rows, and beside them the rb rows the next band adds, which load while
    the band is computed (2 rb + 7 rows), except for V3 on bf16 x, whose new
    rows land raw in a stage and are converted after the band's barrier
    (rb + 7 float32 rows); never more than the image's H rows. Warps: as many
    as fit, at most 16 and at most the band's items (16 pixels by 32 output
    channels); the first rb with at least SLAB_MIN_WARPS (or every item a
    warp) is taken. Blocks: the batch's bands, at most the SMs times the
    blocks an SM holds (by shared memory, and by registers at 128 a thread).
    """
    x_bytes = 2 if dtype == torch.bfloat16 else 4
    slab_bytes = x_bytes if kernel == "deform_fwd_qxhoist" else 4
    convert = slab_bytes != x_bytes
    groups = -(-(_round_up(Cout, 8) // 8) // _NTW)
    for rb in SLAB_ROWS:
        ring_rows = min(rb + 7 if convert else 2 * rb + 7, H)
        items = -(-min(rb, H) * W // 16) * groups
        fixed = slab_layout(W, Cin, Cout, x_bytes, slab_bytes, rb, ring_rows, 0)
        fit = (_MAX_SMEM - fixed["smem"]) // fixed["warp_bytes"]
        warps = min(SLAB_MAX_WARPS, items, fit)
        if warps < 1 or warps < min(SLAB_MIN_WARPS, items):
            continue
        lay = slab_layout(W, Cin, Cout, x_bytes, slab_bytes, rb, ring_rows, warps)
        per_sm = max(1, min(_SMEM_PER_SM // (lay["smem"] + 1024),
                            _REGS_PER_SM_WARPS // warps))
        bands = B * -(-H // rb)
        return {"kernel": kernel, "rb": rb, "ring_rows": ring_rows, "warps": warps,
                "blocks": max(1, min(bands, sms * per_sm)),
                "bands": bands, "convert": convert, **lay}
    return None


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


def _slab_lib() -> ctypes.CDLL:
    from ..utils.build import load_library
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = []
    for k in SLAB_KERNELS:
        sigs += [(k, i32, (ptr,) * 6 + (i32,) * 7 + (ptr,) + (i32,) * 4 + (i64,)),
                 (f"{k}_smem_bytes", i64, (i32,) * 7)]
    return load_library(SLAB_SOURCE, tuple(sigs))


def slab_smem_bytes(plan: dict, W: int, Cin: int, Cout: int, dtype: torch.dtype) -> int:
    """The kernel's own count of the shared memory of `plan` (-1 above what
    a block may use): it must equal `plan["smem"]`, or the launch refuses."""
    return getattr(_slab_lib(), f"{plan['kernel']}_smem_bytes")(
        W, Cin, Cout, int(dtype == torch.bfloat16), plan["rb"], plan["ring_rows"],
        plan["warps"])


def _run_slab(kernel, x, offset, mask, weight, bias, semantics):
    if check_semantics(semantics) != "windowed":
        raise ValueError(f"{kernel} computes windowed semantics only, got {semantics!r}")
    if x.device.type == "cpu":
        return windowed_plain(x, offset, mask, weight, bias)
    if not x.is_cuda:
        raise ValueError(f"{kernel} takes CUDA or CPU tensors, got {x.device}")
    B, H, W, Cin, Cout = _check(x, offset, mask, weight, bias)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = slab_plan(kernel, B, H, W, Cin, Cout, x.dtype, sms)
    if plan is None:
        raise ValueError(f"{kernel} at W={W}, Cin={Cin}, Cout={Cout}, {x.dtype}: no slab plan "
                         f"fits in the {_MAX_SMEM} B of shared memory a block may use")
    launch = getattr(_slab_lib(), kernel)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                     None if bias is None else bias.data_ptr(), out.data_ptr(),
                     B, H, W, Cin, Cout, 1, int(x.dtype == torch.bfloat16), stream,
                     plan["rb"], plan["ring_rows"], plan["warps"], plan["blocks"],
                     plan["smem"])
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
    """V2: K1's function, the Hopper K1's bits, with the corner rows read
    from a ring of input rows in shared memory, in x's type. bias float32
    (Cout,) or None."""
    return _run_slab("deform_fwd_qxhoist", x, offset, mask, weight, bias, semantics)


def deform_cvt1(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor | None = None,
                semantics: str = "windowed") -> torch.Tensor:
    """V3: V2 with the ring in float32, each row converted once as it lands."""
    return _run_slab("deform_fwd_cvt1", x, offset, mask, weight, bias, semantics)


def deform_qxhoist_simt(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor | None = None,
                        semantics: str = "windowed") -> torch.Tensor:
    """V2's first design, on the CUDA cores (the A/B baseline of V2): each
    block stages its rows' input slab, then samples and contracts in the
    SIMT K1's order."""
    return _run("deform_fwd_qxhoist_simt",
                lambda: windowed_plain(x, offset, mask, weight, bias),
                x, offset, mask, weight, bias, semantics)


def deform_cvt1_simt(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor | None = None,
                     semantics: str = "windowed") -> torch.Tensor:
    """V3's first design: `deform_qxhoist_simt` with the slab in float32."""
    return _run("deform_fwd_cvt1_simt",
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


# each variant's wrapper and plain version, keyed by its kernel's name (V2
# and V3 by their Hopper designs)
VARIANTS = {"deform_fwd_bf16_fma": (deform_fwd_bf16_fma, deform_bf16_fma_plain),
            "deform_fwd_qxhoist": (deform_qxhoist, windowed_plain),
            "deform_fwd_cvt1": (deform_cvt1, windowed_plain),
            "deform_fwd_slot_skip": (deform_fwd_slot_skip, windowed_plain),
            "deform_fwd_tapwalk": (deform_fwd_tapwalk, windowed_plain)}
# the first designs of V2 and V3, their A/B baselines, keyed the same way
SIMT_SLAB = {"deform_fwd_qxhoist_simt": (deform_qxhoist_simt, windowed_plain),
             "deform_fwd_cvt1_simt": (deform_cvt1_simt, windowed_plain)}
# the Hopper design of each slab variant and its first design
SLAB_PAIRS = {"deform_fwd_qxhoist": "deform_fwd_qxhoist_simt",
              "deform_fwd_cvt1": "deform_fwd_cvt1_simt"}
