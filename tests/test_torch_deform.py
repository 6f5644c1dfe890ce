"""The port's plain DCNv2 against the JAX package, in float32 on the CPU,
and the arithmetic the Hopper forward kernel's design rests on.

Windowed semantics is held against both JAX windowed forms
(`modulated_deform_conv2d_patch` and the Pallas kernel in interpret mode),
exact semantics against `modulated_deform_conv2d(method="exact")`. The CUDA
kernel itself is held against this plain version on the card by
`chip_smoke.py`; on the CPU the wrapper must route to the plain version
without counting a launch.

The Hopper kernels (`csrc/deform_fwd.cu`, `csrc/deform_bwd.cu`) rest on two
facts held here. (1) The windowed reach: every corner with a non-zero weight
of output (i, j) lies in rows [i - 3, i + 4] and columns [j - 3, j + 4], so
the backward's dx window of a tile's rows catches all of them; exact
semantics leaves that window. (2) The forward's contraction: float32 samples
carried as two bf16 terms (hi = bf16(s), lo = bf16(s - hi)) times the bf16
weight, summed in float32, stay within `deform_variants.compare`'s limits of
the plain version, where one term (samples rounded to bf16) does not; with a
float32 weight split the same way, three products (hi.hi, lo.hi, hi.lo) stay
within float32's 1e-4.

Tolerances: the port sums the four corners and then the taps in another
order than JAX (which contracts one-hot window slots), so float32 results
differ by rounding only: 2e-6 absolute on outputs of magnitude ~1-10, as the
JAX package's own patch-vs-pallas test allows. Exact-vs-JAX-exact uses 1e-5
(the JAX exact path sums corners in a different association as well).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.ops.deform import (modulated_deform_conv2d as jax_dcn,
                                      modulated_deform_conv2d_patch)
from mgdt_yolo_tpu.ops.pallas_deform import modulated_deform_conv2d_pallas
from mgdt_yolo_tpu_torch.ops import cuda_deform
from mgdt_yolo_tpu_torch.ops.deform import (_corners, _sample_fields,
                                            modulated_deform_conv2d_plain)
from mgdt_yolo_tpu_torch.ops.deform_variants import compare

ATOL_WINDOWED = 2e-6
ATOL_EXACT = 1e-5

# (B, H, W, Cin, Cout, offset range, bias): within the +/-2 px reach and
# beyond it, square and rectangular, Cin != Cout, with and without bias
CASES = [
    (2, 16, 16, 4, 6, 1.5, False),
    (2, 16, 16, 4, 6, 4.0, False),
    (1, 8, 24, 8, 4, 1.5, True),
    (1, 8, 24, 8, 4, 4.0, True),
]


def _case(B, H, W, C, O, off_range, with_bias, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = rng.uniform(-off_range, off_range, (B, H, W, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) * 0.2).astype(np.float32)
    bias = rng.standard_normal((O,)).astype(np.float32) if with_bias else None
    return x, off, mask, w, bias


def _port(args, semantics):
    t = [None if a is None else torch.from_numpy(a) for a in args]
    return modulated_deform_conv2d_plain(*t, semantics=semantics).numpy()


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


@pytest.mark.parametrize("case", CASES)
def test_windowed_matches_patch(case):
    args = _case(*case)
    want = np.asarray(modulated_deform_conv2d_patch(*_jax(args)))
    np.testing.assert_allclose(_port(args, "windowed"), want, rtol=0,
                               atol=ATOL_WINDOWED)


@pytest.mark.parametrize("case", CASES)
def test_windowed_matches_pallas_interpret(case):
    args = _case(*case)
    want = np.asarray(modulated_deform_conv2d_pallas(*_jax(args), interpret=True))
    np.testing.assert_allclose(_port(args, "windowed"), want, rtol=0,
                               atol=ATOL_WINDOWED)


@pytest.mark.parametrize("case", CASES)
def test_exact_matches_jax_exact(case):
    args = _case(*case)
    want = np.asarray(jax_dcn(*_jax(args), method="exact"))
    np.testing.assert_allclose(_port(args, "exact"), want, rtol=0, atol=ATOL_EXACT)


# (B, H, W, C, offset range): the widths the Hopper kernels' second plan
# (weight staged by tap) takes, at a small map; the weight is scaled by
# 1 / sqrt(9 C) so every width gives outputs of magnitude ~1
WIDE_CASES = [(1, 8, 8, C, r) for C in (64, 128) for r in (1.5, 4.0)]


@pytest.mark.parametrize("case", WIDE_CASES, ids=[f"C{c[3]}-off{c[4]}" for c in WIDE_CASES])
def test_wide_channels_match_pallas_interpret(case):
    """C 64 and C 128: the plain forward against the JAX Pallas kernel in
    interpret mode, float32, 1e-4 absolute (sums of 9 C products in
    another order)."""
    B, H, W, C, off_range = case
    x, off, mask, w, _ = _case(B, H, W, C, C, off_range, False)
    w = w / 0.2 / np.sqrt(9 * C)
    args = (x, off, mask, w.astype(np.float32), None)
    want = np.asarray(modulated_deform_conv2d_pallas(*_jax(args), interpret=True))
    got = _port(args, "windowed")
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_semantics_differ_beyond_reach():
    """Beyond the reach the two semantics must give different answers (the
    reason the pin exists); within it they agree."""
    far = _case(*CASES[1])
    assert np.abs(_port(far, "windowed") - _port(far, "exact")).max() > 1e-2
    near = _case(*CASES[0])
    np.testing.assert_allclose(_port(near, "windowed"), _port(near, "exact"),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel,counter", [("deform_fwd", "launches"),
                                            ("deform_fwd_simt", "simt_launches")])
def test_cpu_route_uses_plain_and_counts_no_launch(kernel, counter):
    args = _case(*CASES[2])
    t = [None if a is None else torch.from_numpy(a) for a in args]
    before = getattr(cuda_deform, counter)
    want = modulated_deform_conv2d_plain(*t, semantics="windowed")
    got = getattr(cuda_deform, kernel)(*t, semantics="windowed")
    assert getattr(cuda_deform, counter) == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_unknown_semantics_raises():
    args = _case(*CASES[0])
    with pytest.raises(ValueError):
        _port(args, "auto")


def _corner_reach(off_range, semantics, seed=11):
    """For every bilinear corner with a non-zero bilinear weight (ay * ax,
    before the mask and the validity of the tap): its row minus the output
    pixel's row, and its column minus the output pixel's column."""
    B, H, W = 2, 12, 14
    rng = np.random.default_rng(seed)
    off = torch.from_numpy(rng.uniform(-off_range, off_range, (B, H, W, 18)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(0.1, 1.0, (B, H, W, 9)).astype(np.float32))
    y0, fy, x0, fx = _sample_fields(off, mask, semantics == "windowed")[:4]
    i = torch.arange(H, dtype=torch.float32).repeat_interleave(W).reshape(1, H * W, 1)
    j = torch.arange(W, dtype=torch.float32).repeat(H).reshape(1, H * W, 1)
    dys, dxs = [], []
    for dy, dx, _, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        live = (ay * ax * inb) != 0
        dys.append((y0 + dy - i)[live])
        dxs.append((x0 + dx - j)[live])
    return torch.cat(dys), torch.cat(dxs)


@pytest.mark.parametrize("off_range", [1.5, 4.0, 1e3])
def test_windowed_corners_stay_in_reach(off_range):
    """Windowed: every live corner of (i, j) lies in rows [i - 3, i + 4] and
    columns [j - 3, j + 4], however far the offsets reach; both ends of the
    reach are used."""
    dy, dx = _corner_reach(off_range, "windowed")
    assert dy.numel() > 0
    for d in (dy, dx):
        assert d.min().item() >= -3 and d.max().item() <= 4
    if off_range > 2:
        assert dy.min().item() == -3 and dy.max().item() == 4


def test_exact_corners_leave_the_window():
    """Exact semantics at offsets of +-4 reaches past the windowed reach,
    which is why the backward kernel routes such corners to global atomics."""
    dy, dx = _corner_reach(4.0, "exact")
    outside = (dy < -3) | (dy > 4) | (dx < -3) | (dx > 4)
    assert outside.any()


def _samples(x, offset, mask):
    """The plain version's float32 samples, (B, H*W, 9*Cin), windowed."""
    B, H, W, Cin = x.shape
    P = H * W
    y0, fy, x0, fx, wv = _sample_fields(offset, mask, True)[:5]
    xf = x.reshape(B, P, Cin).float()
    s = torch.zeros(B, P * 9, Cin)
    for _, _, idx, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        g = torch.gather(xf, 1, idx.reshape(B, P * 9, 1).expand(-1, -1, Cin))
        s += g * (ay * ax * wv * inb).reshape(B, P * 9, 1)
    return s.reshape(B, P, 9 * Cin)


def _split(t):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _emulated_fwd(args, terms):
    """The Hopper forward's contraction in torch: samples split into bf16
    hi/lo, the weight likewise, `terms` of the products (hi.hi; + lo.hi;
    + hi.lo) summed in float32, the result rounded to x's type."""
    x, offset, mask, weight = args
    s_hi, s_lo = _split(_samples(x, offset, mask))
    w_hi, w_lo = _split(weight.reshape(-1, weight.shape[3]).float())
    out = s_hi @ w_hi
    if terms >= 2:
        out = out + s_lo @ w_hi
    if terms >= 3:
        out = out + s_hi @ w_lo
    return out.reshape(*x.shape[:3], weight.shape[3]).to(x.dtype)


def _emulation_case(off_range, dtype):
    x, off, mask, w, _ = _case(2, 16, 16, 32, 32, off_range, False, seed=5)
    return [torch.from_numpy(a).to(dtype) for a in (x, off, mask, w)]


@pytest.mark.parametrize("off_range", [1.5, 4.0])
def test_two_term_bf16_contraction_within_limits(off_range):
    """bf16: hi + lo samples against the bf16 weight agree with the plain
    version within two bf16 roundings and at most 1% of elements apart."""
    args = _emulation_case(off_range, torch.bfloat16)
    want = modulated_deform_conv2d_plain(*args, semantics="windowed")
    held = compare(_emulated_fwd(args, 2), want)
    assert held["ok"], held


@pytest.mark.parametrize("off_range", [1.5, 4.0])
def test_one_term_bf16_contraction_fails_limits(off_range):
    """The control: samples rounded to bf16 alone compute another function,
    which the limits tell apart (as V1's does)."""
    args = _emulation_case(off_range, torch.bfloat16)
    want = modulated_deform_conv2d_plain(*args, semantics="windowed")
    held = compare(_emulated_fwd(args, 1), want)
    assert not held["ok"] and held["mismatch_share"] > 10 * held["share_limit"], held


@pytest.mark.parametrize("off_range", [1.5, 4.0])
def test_three_term_float32_contraction_within_1e4(off_range):
    """float32: hi.hi + lo.hi + hi.lo stays within float32's 1e-4."""
    args = _emulation_case(off_range, torch.float32)
    want = modulated_deform_conv2d_plain(*args, semantics="windowed")
    held = compare(_emulated_fwd(args, 3), want)
    assert held["ok"] and held["tol"] == 1e-4, held
