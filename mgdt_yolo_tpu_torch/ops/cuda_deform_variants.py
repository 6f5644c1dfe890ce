"""Wrappers of the K1 variants, hand-written CUDA kernels of the DCNv2
forward, each the Hopper counterpart of one TPU prototype (the repo-root
`tools/proto_deform_*.py`):

* `deform_fwd_bf16_fma` (V1): bf16 corner weights and bf16 corner products;
* `deform_qxhoist` (V2): the input rows staged once per block in shared
  memory, in x's type;
* `deform_cvt1` (V3): V2 with the staged rows converted to float32 once;
* `deform_fwd_slot_skip` (V4): zero-weight corners and dead taps skipped;
* `deform_fwd_tapwalk` (V5): the contraction walked tap-outer, one tap's
  weight slice resident.

All five are redesigned on the Hopper K1's tensor-core design. V2-V5 give
its bits: V2 and V3 (`csrc/deform_fwd_slab.cu`) fed from a ring of input
rows in shared memory, loaded asynchronously; V4 and V5
(`csrc/deform_fwd_tc_variants.cu`) with K1's per-warp corner gathers, V4
skipping dead work and V5 holding one tap's weight slice in place of nine.
V1 (`csrc/deform_fwd_tc_variants.cu`) computes its own function with K1's
plan and gathers, its bf16 corner products fed to the tensor cores as four
times the contraction depth. Their plans (`slab_plan`: rows per band, ring
rows, warps, blocks, bytes; `tc_plan`: warps, items per warp, blocks,
bytes) are chosen here and passed to the kernel, which refuses a plan its
own layout disagrees with. Their first designs, on the CUDA cores, stay in
`csrc/deform_fwd_variants.cu` as their A/B baseline (`FIRST_DESIGNS`):
`deform_fwd_bf16_fma_simt`, `deform_qxhoist_simt`, `deform_cvt1_simt`,
`deform_fwd_slot_skip_simt` and `deform_fwd_tapwalk_simt`.

They take the JAX tools' signatures (NHWC x, offset, mask, weight; `bias`
for V2 and V3) and windowed semantics only. For CUDA tensors each launches
its kernel on the current stream; a CPU tensor goes to its plain version
(`ops/deform_variants.py`: V1's own, K1's windowed plain version for V2-V5)
without counting a launch. Any other input the kernels do not take raises:
exact semantics, more shared memory than a block may use (V2 and V3: no
slab plan fits, as at C 64; V4 and V1 above K1's resident plan, V5 where not
one warp fits), a non-contiguous or mistyped tensor (K1's checks,
`cuda_deform._check`), and for V1's first design in bf16 an odd Cin or an x
not aligned to 4 bytes (it reads channel pairs). Nothing falls back. `launches` counts each
kernel's launches, keyed by its C entry point; `smem_bytes` gives the shared
memory one block of a CUDA-core kernel needs.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_deform
from .cuda_deform import _MAX_SMEM, _check, _library
from .deform import check_semantics
from .deform_variants import deform_bf16_fma_plain, windowed_plain

SOURCE = "deform_fwd_variants"      # csrc/deform_fwd_variants.cu: the CUDA-core designs
SLAB_SOURCE = "deform_fwd_slab"     # csrc/deform_fwd_slab.cu: the Hopper V2 and V3
SLAB_KERNELS = ("deform_fwd_qxhoist", "deform_fwd_cvt1")
TC_SOURCE = "deform_fwd_tc_variants"  # csrc/deform_fwd_tc_variants.cu: the Hopper V4, V5, V1
TC_KERNELS = ("deform_fwd_slot_skip", "deform_fwd_tapwalk", "deform_fwd_bf16_fma")

# launches of each variant's kernel since its count was last set to 0
launches = dict.fromkeys(("deform_fwd_bf16_fma", "deform_fwd_qxhoist", "deform_fwd_cvt1",
                          "deform_fwd_slot_skip", "deform_fwd_tapwalk",
                          "deform_fwd_bf16_fma_simt", "deform_fwd_qxhoist_simt",
                          "deform_fwd_cvt1_simt", "deform_fwd_slot_skip_simt",
                          "deform_fwd_tapwalk_simt"), 0)

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


# The Hopper V4 / V5 / V1 plan. Warps a block may have at each number of items a
# warp carries over the taps: the kernel's launch bound (512 threads, so 128
# registers a thread, as K1; two items' 16 more float32 sums a lane take 384
# and 168). They are also the warps an SM holds by registers.
TC_MAX_WARPS = {1: 16, 2: 12}


def tc_layout(Cin: int, Cout: int, x_bytes: int, weight_taps: int, warps: int,
              items_per_warp: int) -> dict:
    """The shared memory of one block of the Hopper V4, V5 or V1 (`layout` in
    `csrc/deform_fwd_tc_variants.cu`, which the launch recomputes), K1's own
    layout (`csrc/deform_fwd.cu`): `weight_taps` taps of the weight as bf16
    B fragments, (Cout padded to 8, Cin padded to 16 plus 8), hi and, for
    float32, lo; then per warp the (16, Cin) hi/lo samples, two taps' corner
    fields, each item's offsets and mask and the double-buffered corner
    stage (16 pixels x 4 corners x Cin, 16-byte rows; or the epilogue's
    (16, 36) float32 staging over it). `weight_scratch` counts the bf16
    elements of V5's global copy of the weight in that layout. Sizes in
    bytes."""
    CK = _round_up(Cin, 16)
    SA, NP = CK + 8, _round_up(Cout, 8)
    parts = 2 if x_bytes == 4 else 1
    weight = weight_taps * NP * SA * 2 * parts
    stage = max(2 * 16 * 4 * _round_up(Cin, 16 // x_bytes) * x_bytes, 16 * (_NTW * 8 + 4) * 4)
    warp = 2 * 16 * SA * 2 + 2 * 2 * 16 * 4 * 4 + \
        items_per_warp * _round_up(16 * 27 * x_bytes, 16) + stage
    return {"weight_bytes": weight, "warp_bytes": warp, "smem": weight + warps * warp,
            "weight_scratch": parts * 9 * NP * SA}


def tc_plan(kernel: str, B: int, H: int, W: int, Cin: int, Cout: int, dtype: torch.dtype,
            sms: int, warps: int | None = None, items_per_warp: int | None = None) -> dict:
    """The plan of the Hopper V4 ("deform_fwd_slot_skip"), V5
    ("deform_fwd_tapwalk") or V1 ("deform_fwd_bf16_fma") at x (B, H, W,
    Cin), Cout output channels, x's `dtype`, on a card of `sms` SMs. Raises
    ValueError where not one warp fits in a block's shared memory.
    `warps` and `items_per_warp` force V5's plan (its tool's A/B of plans);
    they raise where they do not fit.

    V4 and V1 hold the 9 taps' weight and one item per warp: K1's resident
    plan, the same bytes and warps (at most 16). V1 on bf16 x leaves the
    (16, Cin) hi/lo sample blocks of each warp unused (`unused_a_bytes`; its
    products go to the tensor cores from registers), and does not spend
    them on warps, so that its A/B against K1 measures its arithmetic
    alone. V5 holds two taps' slices (the
    one contracted and the next, loading) and takes the most warps that fit
    (at most TC_MAX_WARPS for its items per warp), then the most items per
    warp, 1 or 2: a warp's items share the round's block barrier per tap.
    Blocks: V4's warps take items (16 pixels by up to 32 output channels)
    each on its own, V5's a round of warps x items per warp at a time; at
    most the SMs times the blocks an SM holds by shared memory and
    registers."""
    x_bytes = 2 if dtype == torch.bfloat16 else 4
    walk = kernel == "deform_fwd_tapwalk"
    if kernel not in TC_KERNELS or items_per_warp not in (None, *TC_MAX_WARPS):
        raise ValueError(f"{kernel} is not one of {TC_KERNELS}, or {items_per_warp} items "
                         f"a warp is not one of {tuple(TC_MAX_WARPS)}")
    taps = 2 if walk else 9
    best = None
    for ipw in ((1, 2) if walk else (1,)) if items_per_warp is None else (items_per_warp,):
        fixed = tc_layout(Cin, Cout, x_bytes, taps, 0, ipw)
        fit = min(TC_MAX_WARPS[ipw], (_MAX_SMEM - fixed["smem"]) // fixed["warp_bytes"])
        n = fit if warps is None else warps if warps <= fit else 0
        if n >= 1 and (best is None or n >= best[0]):
            best = (n, ipw)
    if best is None or (not walk and (warps, items_per_warp) != (None, None)):
        raise ValueError(f"{kernel} at Cin={Cin}, Cout={Cout}, {dtype}: not one warp fits in "
                         f"the {_MAX_SMEM} B of shared memory a block may use (or the plan "
                         f"asked for: {warps} warps x {items_per_warp} items)")
    warps, ipw = best
    lay = tc_layout(Cin, Cout, x_bytes, taps, warps, ipw)
    items = B * -(-H * W // 16) * -(-_round_up(Cout, 8) // 8 // _NTW)
    per_sm = max(1, min(_SMEM_PER_SM // (lay["smem"] + 1024), TC_MAX_WARPS[ipw] // warps))
    unused = warps * 2 * 16 * (_round_up(Cin, 16) + 8) * 2 \
        if kernel == "deform_fwd_bf16_fma" and x_bytes == 2 else 0
    return {"kernel": kernel, "warps": warps, "items_per_warp": ipw, "items": items,
            "blocks": max(1, min(-(-items // (warps * ipw)), sms * per_sm)),
            "unused_a_bytes": unused, **lay}


def hopper_k1_plan(Cin: int, Cout: int, dtype: torch.dtype) -> dict:
    """The plan the Hopper K1 (`cuda_deform.deform_fwd`) takes at these
    widths: "resident" or "streamed", its shared memory per block (the
    kernel's own count) and its warps, from those bytes and the layout V4
    and V5 share with it (`tc_layout`). Builds K1's library."""
    bf16 = int(dtype == torch.bfloat16)
    kind = cuda_deform.plan("deform_fwd", Cin=Cin, Cout=Cout, bf16=bf16)
    smem = cuda_deform._kernel_smem("deform_fwd", Cin=Cin, Cout=Cout, bf16=bf16)
    lay = tc_layout(Cin, Cout, 2 if bf16 else 4, 9 if kind == "resident" else 1, 0, 1)
    warps, rest = divmod(smem - lay["weight_bytes"], lay["warp_bytes"])
    if kind == "none" or rest:
        raise ValueError(f"the Hopper K1's {smem} B at C {Cin} -> {Cout} are not its layout's")
    return {"plan": kind, "warps": warps, "smem": smem}


def _tc_lib() -> ctypes.CDLL:
    from ..utils.build import load_library
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = []
    for k in TC_KERNELS:
        sigs += [(k, i32, (ptr,) * 7 + (i32,) * 7 + (ptr,) + (i32,) * 3 + (i64,)),
                 (f"{k}_smem_bytes", i64, (i32,) * 5)]
    return load_library(TC_SOURCE, tuple(sigs))


def tc_smem_bytes(plan: dict, Cin: int, Cout: int, dtype: torch.dtype) -> int:
    """The kernel's own count of the shared memory of `plan` (-1 above what
    a block may use): it must equal `plan["smem"]`, or the launch refuses."""
    return getattr(_tc_lib(), f"{plan['kernel']}_smem_bytes")(
        Cin, Cout, int(dtype == torch.bfloat16), plan["warps"], plan["items_per_warp"])


def _run_tc(kernel, x, offset, mask, weight, semantics, plan=None, plain=windowed_plain):
    if check_semantics(semantics) != "windowed":
        raise ValueError(f"{kernel} computes windowed semantics only, got {semantics!r}")
    if x.device.type == "cpu":
        return plain(x, offset, mask, weight)
    if not x.is_cuda:
        raise ValueError(f"{kernel} takes CUDA or CPU tensors, got {x.device}")
    B, H, W, Cin, Cout = _check(x, offset, mask, weight, None)
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = plan or tc_plan(kernel, B, H, W, Cin, Cout, x.dtype, sms)
    scratch = torch.empty(plan["weight_scratch"], dtype=torch.bfloat16, device=x.device) \
        if kernel == "deform_fwd_tapwalk" else None
    launch = getattr(_tc_lib(), kernel)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(), None,
                     out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                     B, H, W, Cin, Cout, 1, int(x.dtype == torch.bfloat16), stream,
                     plan["warps"], plan["items_per_warp"], plan["blocks"], plan["smem"])
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launches[kernel] += 1
    return out


def deform_fwd_bf16_fma(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                        weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """V1: corner weights rounded to bf16, corner products in x's type,
    float32 sums (`deform_bf16_fma_plain` is its function), on the Hopper
    K1's resident plan (`tc_plan`), its bf16 corner products contracted on
    the tensor cores as they are. No bias."""
    return _run_tc("deform_fwd_bf16_fma", x, offset, mask, weight, semantics,
                   plain=deform_bf16_fma_plain)


def deform_fwd_bf16_fma_simt(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                             weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """V1's first design, on the CUDA cores (the A/B baseline of V1): V1's
    function in the SIMT K1's blocks. No bias. In bf16 it reads x's channels
    in pairs: Cin even (its `smem_bytes` is -1 for an odd one) and x aligned
    to 4 bytes."""
    if x.is_cuda and x.dtype == torch.bfloat16 and x.data_ptr() % 4:
        raise ValueError("deform_fwd_bf16_fma_simt reads bf16 channel pairs: x must be "
                         "aligned to 4 bytes")
    return _run("deform_fwd_bf16_fma_simt",
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
    """V4: the Hopper K1 with zero-weight corners and dead taps (no live
    corner in a warp's 16 pixels) skipped; the Hopper K1's bits on finite
    inputs. Takes K1's resident plan only (`tc_plan`)."""
    return _run_tc("deform_fwd_slot_skip", x, offset, mask, weight, semantics)


def deform_fwd_tapwalk(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                       weight: torch.Tensor, semantics: str = "windowed",
                       plan: dict | None = None) -> torch.Tensor:
    """V5: K1's function contracted tap-outer by persistent blocks that hold
    one tap's weight slice (and the next, loading) in place of nine, with
    more warps where that frees shared memory; the Hopper K1's bits. `plan`
    (a `tc_plan` of these shapes) replaces the chosen one, for the tool's
    A/B of plans; the kernel refuses one whose bytes it counts otherwise."""
    return _run_tc("deform_fwd_tapwalk", x, offset, mask, weight, semantics, plan)


def deform_fwd_slot_skip_simt(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                              weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """V4's first design, on the CUDA cores (the A/B baseline of V4): the
    SIMT K1 with zero-weight corners and dead (pixel, tap) pairs skipped;
    the SIMT K1's bits on finite inputs."""
    return _run("deform_fwd_slot_skip_simt",
                lambda: windowed_plain(x, offset, mask, weight),
                x, offset, mask, weight, None, semantics)


def deform_fwd_tapwalk_simt(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor, semantics: str = "windowed") -> torch.Tensor:
    """V5's first design: the SIMT K1's function contracted tap by tap on
    the CUDA cores (Cout <= 128); the SIMT K1's bits."""
    return _run("deform_fwd_tapwalk_simt",
                lambda: windowed_plain(x, offset, mask, weight),
                x, offset, mask, weight, None, semantics)


# each variant's wrapper and plain version, keyed by its kernel's name
# (by their Hopper designs)
VARIANTS = {"deform_fwd_bf16_fma": (deform_fwd_bf16_fma, deform_bf16_fma_plain),
            "deform_fwd_qxhoist": (deform_qxhoist, windowed_plain),
            "deform_fwd_cvt1": (deform_cvt1, windowed_plain),
            "deform_fwd_slot_skip": (deform_fwd_slot_skip, windowed_plain),
            "deform_fwd_tapwalk": (deform_fwd_tapwalk, windowed_plain)}
# every variant redesigned for Hopper, keyed by its kernel: its first design
# on the CUDA cores, its A/B baseline, as (kernel, wrapper, plain version)
FIRST_DESIGNS = {
    "deform_fwd_bf16_fma": ("deform_fwd_bf16_fma_simt", deform_fwd_bf16_fma_simt,
                            deform_bf16_fma_plain),
    "deform_fwd_qxhoist": ("deform_fwd_qxhoist_simt", deform_qxhoist_simt, windowed_plain),
    "deform_fwd_cvt1": ("deform_fwd_cvt1_simt", deform_cvt1_simt, windowed_plain),
    "deform_fwd_slot_skip": ("deform_fwd_slot_skip_simt", deform_fwd_slot_skip_simt,
                             windowed_plain),
    "deform_fwd_tapwalk": ("deform_fwd_tapwalk_simt", deform_fwd_tapwalk_simt, windowed_plain)}
