"""The port's plain DCNv2 against the JAX package, in float32 on the CPU.

Windowed semantics is held against both JAX windowed forms
(`modulated_deform_conv2d_patch` and the Pallas kernel in interpret mode),
exact semantics against `modulated_deform_conv2d(method="exact")`. The CUDA
kernel itself is held against this plain version on the card by
`chip_smoke.py`; on the CPU the wrapper must route to the plain version
without counting a launch.

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
from mgdt_yolo_tpu_torch.ops.deform import modulated_deform_conv2d_plain

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


def test_semantics_differ_beyond_reach():
    """Beyond the reach the two semantics must give different answers (the
    reason the pin exists); within it they agree."""
    far = _case(*CASES[1])
    assert np.abs(_port(far, "windowed") - _port(far, "exact")).max() > 1e-2
    near = _case(*CASES[0])
    np.testing.assert_allclose(_port(near, "windowed"), _port(near, "exact"),
                               rtol=0, atol=1e-5)


def test_cpu_route_uses_plain_and_counts_no_launch():
    args = _case(*CASES[2])
    t = [None if a is None else torch.from_numpy(a) for a in args]
    before = cuda_deform.launches
    want = modulated_deform_conv2d_plain(*t, semantics="windowed")
    got = cuda_deform.deform_fwd(*t, semantics="windowed")
    assert cuda_deform.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_unknown_semantics_raises():
    args = _case(*CASES[0])
    with pytest.raises(ValueError):
        _port(args, "auto")
