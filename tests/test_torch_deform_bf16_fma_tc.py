"""The Hopper V1 (`csrc/deform_fwd_tc_variants.cu` `bf16_fma_kernel`) on the
CPU: the arithmetic its design rests on, its A-fragment reads from K1's
corner stage, its plan and its place in the registries.

The kernel runs only on the card, where `chip_smoke.py` holds it to V1's
plain version (`deform_bf16_fma_plain`) and to its first design within
`deform_variants.compare`'s limits; `test_torch_deform_variants.py` holds
that plain version against the JAX prototype. Checked here:

* V1's function is one contraction over (corner, channel) of the exact
  bf16 corner products bf16(bf16(w) * x) with the weight: a model that
  keeps each corner's products as separate contraction terms and sums them
  in float32 in the kernel's order (tap, 16-channel step, corner) stays
  within `compare`'s limits of the plain version, in bf16, on several
  seeds and on ragged shapes with Cin 24 and 21, and falls outside K1's;
* `_walk` follows `contract_corners`'s lane -> (pixel, stage row slot
  q ^ (p & 1), channels) reads and its fragment registers step by step,
  on a stage whose unwritten rows and columns hold NaN: every (pixel,
  corner, channel < Cin) of a live corner is read once per tap, nothing
  else is read, the permutation of channels within a 16-channel step is
  the same in A and B, and the fragments contract to the products' sum.
  A change to that function's loop must be made in `_walk` too;
* `tc_plan("deform_fwd_bf16_fma", ...)` is the Hopper K1's resident plan
  (V4's), with the A-block bytes the bf16 path leaves unused reported, and
  refuses where only K1's streamed plan fits;
* V1 is in `TC_KERNELS` and `FIRST_DESIGNS` with its own plain version.

Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu_torch.ops import cuda_deform_variants as cdv
from mgdt_yolo_tpu_torch.ops.deform import _corners, _sample_fields
from mgdt_yolo_tpu_torch.ops.deform_variants import (compare, deform_bf16_fma_plain,
                                                     windowed_plain)

SMS = 132                   # an H100's SMs
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAME = "deform_fwd_bf16_fma"


def _inputs(seed, B=2, H=16, W=24, C=8, O=16, off_range=3.0):
    """bf16 inputs: x ~ N(0, 1), offsets U(-off_range, off_range) (in and
    beyond the +-2 px reach), mask U(0, 1), weight N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C))
    off = rng.uniform(-off_range, off_range, (B, H, W, 18))
    mask = rng.uniform(0, 1, (B, H, W, 9))
    w = rng.standard_normal((3, 3, C, O)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in (x, off, mask, w)]


def _corner_products(x, off, mask):
    """Each corner's bf16 products bf16(bf16((ay * ax) * wv) * x) as float32,
    (B, P, 9, 4, Cin), 0 for a corner outside the image: the A operand the
    kernel feeds the tensor cores, before it is cut into 16-channel steps."""
    B, H, W, C = x.shape
    y0, fy, x0, fx, wv = _sample_fields(off, mask, True)[:5]
    xs = x.reshape(B, H * W, C)
    prods = []
    for _, _, idx, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        cw = (ay * ax * wv).to(torch.bfloat16).reshape(B, -1, 1)
        g = torch.gather(xs, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        prods.append(torch.where(inb.reshape(B, -1, 1) > 0, (cw * g).float(), 0.0))
    return torch.stack(prods, 2).reshape(B, H * W, 9, 4, C)


def _design(x, off, mask, w):
    """V1's function as the Hopper V1 computes it on bf16 x: the corner
    products contracted with the bf16 weight over (corner, channel), one
    float32 product sum per (tap, 16-channel step, corner) added to the
    float32 sums in that order (the kernel's `mma.sync` sequence)."""
    B, H, W, C = x.shape
    O = w.shape[3]
    prods = _corner_products(x, off, mask)
    wk = w.float().reshape(9, C, O)
    acc = torch.zeros(B, H * W, O)
    for k in range(9):
        for kk in range(0, C, 16):
            for q in range(4):
                acc = acc + prods[:, :, k, q, kk:kk + 16] @ wk[k, kk:kk + 16]
    return acc.reshape(B, H, W, O).to(torch.bfloat16)


@pytest.mark.parametrize("seed, shape", [(0, (2, 16, 24, 8, 16)), (1, (2, 16, 24, 8, 16)),
                                         (2, (2, 16, 24, 8, 16)), (3, (2, 20, 28, 24, 32)),
                                         (4, (2, 13, 21, 24, 32)), (5, (2, 13, 21, 21, 8))])
def test_corner_products_as_contraction_depth(seed, shape):
    B, H, W, C, O = shape
    args = _inputs(seed, B, H, W, C, O)
    got = _design(*args)
    v1 = compare(got, deform_bf16_fma_plain(*args))
    assert v1["ok"], v1
    assert v1["mismatch_share"] < 0.002     # the order of float32 sums only
    k1 = compare(got, windowed_plain(*args))
    assert not k1["ok"] and k1["mismatch_share"] > 0.2, k1     # not K1's function


# ---------------------------------------------------------------- the reads

def _fragment_depth(t):
    """The channel offsets within a 16-channel step that the fragment depth
    0..15 of lane (g, t)'s registers holds: A regs 0/1 and B reg 0 at depth
    2t, 2t + 1 hold channels 4t, 4t + 1; A regs 2/3 and B reg 1 at depth
    2t + 8, 2t + 9 hold channels 4t + 2, 4t + 3."""
    return {2 * t: 4 * t, 2 * t + 1: 4 * t + 1, 2 * t + 8: 4 * t + 2, 2 * t + 9: 4 * t + 3}


def _walk(stage, fw, fi, wk, Cin, RS):
    """One warp's `contract_corners` over one tap, lane by lane: for each
    16-channel step kk and corner q, lane (g, t) reads channels kk + 4t ..
    kk + 4t + 3 of row slot q ^ (g & 1) of pixels g and g + 8 (8 bf16 from
    `stage`, (16, 4, RS), where the row lies inside the array), zeroes a
    dead corner's (fi < 0) and channels past Cin without reading them,
    multiplies by the corner weight rounded to bf16 (bf16 x bf16 rounds to
    bf16) and packs the fragments; `mma.sync` is the PTX layout's sum (A
    rows g / g + 8, B column g) in float64. Returns the (16, NP) sums, the
    reads as {(pixel, slot, channel): count} and the depth -> channel map
    each lane's A and B registers used."""
    NP = wk.shape[0]
    CK = -(-Cin // 16) * 16
    acc = np.zeros((16, NP))
    reads, perm_a, perm_b = {}, {}, {}
    for kk in range(0, CK, 16):
        for q in range(4):
            A = np.zeros((16, 16))
            B = np.zeros((16, NP))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                c0 = kk + 4 * t
                for h in range(2):
                    p = g + 8 * h
                    slot = q ^ (g & 1)
                    vals = torch.zeros(4, dtype=torch.bfloat16)
                    if fi[p, q] >= 0 and c0 < Cin:
                        assert c0 + 3 < RS, "an 8-byte read past the row"
                        for u in range(4):
                            reads[(p, slot, c0 + u)] = reads.get((p, slot, c0 + u), 0) + 1
                        vals = stage[p, slot, c0:c0 + 4].clone()
                        vals[max(Cin - c0, 0):] = 0     # channels past Cin: masked
                    w2 = torch.tensor(fw[p, q], dtype=torch.float32).to(torch.bfloat16)
                    prods = (w2 * vals).double().numpy()
                    for depth, ch in _fragment_depth(t).items():
                        A[p, depth] = prods[ch - 4 * t]
                        perm_a.setdefault((kk, depth), set()).add(kk + ch)
                for j in range(NP // 8):
                    n = 8 * j + g
                    for depth, ch in _fragment_depth(t).items():
                        B[depth, n] = wk[n, kk + ch]
                        perm_b.setdefault((kk, depth), set()).add(kk + ch)
            acc += A @ B
    return acc, reads, perm_a, perm_b


@pytest.mark.parametrize("Cin, Cout, seed", [(32, 32, 0), (24, 32, 1), (21, 8, 2), (8, 16, 3),
                                             (64, 32, 4)])
def test_reads_of_the_corner_stage(Cin, Cout, seed):
    rng = np.random.default_rng(seed)
    RS = -(-Cin // 8) * 8       # the stage's bf16 row stride: Cin padded to 16 bytes
    CK, NP = -(-Cin // 16) * 16, -(-Cout // 8) * 8
    # gather_corner's stage: pixel p's corner q in row slot q ^ (p & 1); a
    # dead corner (fi -1, weight 0) and the columns past Cin hold NaN bits
    stage = torch.full((16, 4, RS), float("nan"), dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((16, 4, Cin)).astype(np.float32)).to(torch.bfloat16)
    fi = rng.integers(0, 100, (16, 4))
    fi[rng.uniform(size=(16, 4)) < 0.3] = -1
    fi[13:] = -1                # a short item: pixels past np have no corners
    fw = np.where(fi >= 0, rng.uniform(0, 1, (16, 4)), 0.0).astype(np.float32)
    for p in range(16):
        for q in range(4):
            if fi[p, q] >= 0:
                stage[p, q ^ (p & 1), :Cin] = x[p, q]
    # the tap's weight slice as stage_weight writes it: (NP, SA), zero past
    # Cin and Cout
    w = rng.standard_normal((Cin, Cout)).astype(np.float32) * 0.1
    wk = np.zeros((NP, CK + 8))
    wk[:Cout, :Cin] = torch.from_numpy(w).to(torch.bfloat16).double().numpy().T

    acc, reads, perm_a, perm_b = _walk(stage, fw, fi, wk, Cin, RS)

    want = {(p, q ^ (p & 1), c): 1 for p in range(16) for q in range(4) if fi[p, q] >= 0
            for c in range(Cin)}
    assert {k: v for k, v in reads.items() if k[2] < Cin} == want   # each once, nothing dead
    assert all(c < RS for _, _, c in reads)     # past Cin only inside the row, then masked
    for (kk, depth), chans in perm_a.items():   # one channel per depth, the same in A and B
        assert chans == perm_b[(kk, depth)] and len(chans) == 1
    assert sorted(c for (kk, _), ch in perm_a.items() if kk == 0 for c in ch) == list(range(16))
    prods = (torch.from_numpy(fw).to(torch.bfloat16)[..., None] * x).double()
    prods[torch.from_numpy(fi < 0)] = 0
    direct = np.einsum("pqc,co->po", prods.numpy(), wk[:Cout, :Cin].T)
    assert np.isfinite(acc).all()
    np.testing.assert_allclose(acc[:, :Cout], direct, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- the plan

def _plan(kernel, C, dtype):
    return cdv.tc_plan(kernel, 32, 80, 80, C, C, DTYPES[dtype], SMS)


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_is_k1_resident_plan(dtype, C):
    v1, v4 = _plan(NAME, C, dtype), _plan("deform_fwd_slot_skip", C, dtype)
    assert {k: v for k, v in v1.items() if k not in ("kernel", "unused_a_bytes")} == \
        {k: v for k, v in v4.items() if k not in ("kernel", "unused_a_bytes")}
    # K1's resident plan (chip_smoke.py C32_SMEM at C 32; tc_layout's bytes at C 64)
    want = {("float32", 32): (8, 219648), ("bfloat16", 32): (16, 225280),
            ("float32", 64): (1, 206016), ("bfloat16", 64): (6, 220224)}[dtype, C]
    assert (v1["warps"], v1["smem"]) == want and v1["items_per_warp"] == 1
    SA = -(-C // 16) * 16 + 8
    assert v1["unused_a_bytes"] == (v1["warps"] * 2 * 16 * SA * 2 if dtype == "bfloat16" else 0)
    assert v4["unused_a_bytes"] == 0


@pytest.mark.parametrize("C, dtype", [(128, "bfloat16"), (96, "float32")])
def test_plan_refuses_where_only_k1_streamed_plan_fits(C, dtype):
    with pytest.raises(ValueError, match="not one warp fits"):
        _plan(NAME, C, dtype)


# ---------------------------------------------------------------- registries

def test_v1_is_a_tc_kernel_with_its_first_design():
    assert NAME in cdv.TC_KERNELS
    simt, fn, plain = cdv.FIRST_DESIGNS[NAME]
    assert (simt, fn.__name__) == (f"{NAME}_simt", f"{NAME}_simt")
    assert plain is deform_bf16_fma_plain and cdv.VARIANTS[NAME][1] is deform_bf16_fma_plain
    assert {NAME, simt} <= set(cdv.launches)


def test_v1_wrappers_route_cpu_to_v1_plain():
    args = [t.float() for t in _inputs(7)]
    want = deform_bf16_fma_plain(*args)
    before = dict(cdv.launches)
    for fn in (cdv.deform_fwd_bf16_fma, cdv.deform_fwd_bf16_fma_simt):
        torch.testing.assert_close(fn(*args), want, rtol=0, atol=0)
    assert cdv.launches == before
