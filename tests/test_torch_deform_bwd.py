"""The port's DCNv2 backward against autograd and the JAX package, and the
differentiable DCN (`ops.cuda_deform.deform_conv`) on the CPU, in float32.

`modulated_deform_conv2d_plain_bwd` is the plain version the CUDA backward
kernel (`csrc/deform_bwd.cu`) is held against on the card by
`chip_smoke.py`. Here it is held:

* against autograd through the port's plain forward, in both semantics:
  the two compute the same sums in another order, so they agree to float32
  rounding; the tolerance is 1e-5 absolute plus 1e-5 of the value (the
  weight gradient sums 512 products and reaches ~50);
* against the JAX package's own backward: windowed against `jax.vjp` of
  `modulated_deform_conv2d_pallas_vjp` in interpret mode (the custom VJP
  with the TPU backward kernel), exact against `jax.vjp` of
  `modulated_deform_conv2d(method="exact")`, at 1e-4 absolute and relative,
  the tolerance `tests/test_pallas_deform.py` uses for the same gradients.

The Hopper backward kernel's two contractions (tap gradient g . W^T and
weight gradient s^T . g) run on bf16 tensor cores: on the bf16 path their
operands are bf16-exact, and on the float32 path each operand is split into
bf16 hi + lo with three products kept (hi.hi, lo.hi, hi.lo); both are held
here against the float32 products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.ops.deform import modulated_deform_conv2d as jax_dcn
from mgdt_yolo_tpu.ops.pallas_deform import modulated_deform_conv2d_pallas_vjp
from mgdt_yolo_tpu_torch.ops import cuda_deform
from mgdt_yolo_tpu_torch.ops.deform import (modulated_deform_conv2d_plain,
                                            modulated_deform_conv2d_plain_bwd)

TOL_AUTOGRAD = 1e-5
TOL_JAX = 1e-4
NAMES = ("x", "offset", "mask", "weight")

# (B, H, W, Cin, Cout, offset range): within the +/-2 px reach and beyond
# it (many taps clamped), square and rectangular
CASES = [(2, 16, 16, 4, 6, 1.5), (2, 16, 16, 4, 6, 4.0),
         (1, 8, 24, 8, 4, 1.5), (1, 8, 24, 8, 4, 4.0)]
IDS = ["16x16-near", "16x16-far", "8x24-near", "8x24-far"]


def _case(B, H, W, C, O, off_range, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = rng.uniform(-off_range, off_range, (B, H, W, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) * 0.2).astype(np.float32)
    g = rng.standard_normal((B, H, W, O)).astype(np.float32)
    return (x, off, mask, w), g


def _plain_bwd(args, g, semantics):
    t = [torch.from_numpy(a) for a in args]
    grads = modulated_deform_conv2d_plain_bwd(*t, torch.from_numpy(g), semantics)
    return [gr.numpy() for gr in grads]


def _check(got, want, tol):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=f"gradient of {name}")


@pytest.mark.parametrize("semantics", ["windowed", "exact"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_bwd_matches_autograd(case, semantics):
    args, g = _case(*case)
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    out = modulated_deform_conv2d_plain(*t, semantics=semantics)
    out.backward(torch.from_numpy(g))
    _check(_plain_bwd(args, g, semantics), [a.grad.numpy() for a in t], TOL_AUTOGRAD)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_bwd_matches_jax_pallas_vjp(case):
    args, g = _case(*case)
    _, vjp = jax.vjp(lambda *a: modulated_deform_conv2d_pallas_vjp(*a, interpret=True),
                     *[jnp.asarray(a) for a in args])
    _check(_plain_bwd(args, g, "windowed"), vjp(jnp.asarray(g)), TOL_JAX)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_exact_bwd_matches_jax_exact(case):
    args, g = _case(*case)
    _, vjp = jax.vjp(lambda *a: jax_dcn(*a, method="exact"),
                     *[jnp.asarray(a) for a in args])
    _check(_plain_bwd(args, g, "exact"), vjp(jnp.asarray(g)), TOL_JAX)


# (B, H, W, C, offset range): the widths the Hopper kernels' second plan
# takes, at a small map; weight scaled by 1 / sqrt(9 C)
WIDE_CASES = [(1, 8, 8, C, r) for C in (64, 128) for r in (1.5, 4.0)]


@pytest.mark.parametrize("case", WIDE_CASES, ids=[f"C{c[3]}-off{c[4]}" for c in WIDE_CASES])
def test_wide_channels_bwd_match_jax_pallas_vjp(case):
    """C 64 and C 128: the plain backward against `jax.vjp` of the Pallas
    custom VJP in interpret mode, float32; each gradient within 1e-3 of
    its largest value (the weight gradient sums 576 terms per element,
    d offset and d mask 9 C products per tap, in another order)."""
    B, H, W, C, off_range = case
    (x, off, mask, w), g = _case(B, H, W, C, C, off_range)
    args = (x, off, mask, (w / 0.2 / np.sqrt(9 * C)).astype(np.float32))
    _, vjp = jax.vjp(lambda *a: modulated_deform_conv2d_pallas_vjp(*a, interpret=True),
                     *[jnp.asarray(a) for a in args])
    for name, got, want in zip(NAMES, _plain_bwd(args, g, "windowed"), vjp(jnp.asarray(g))):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got - want).max() <= 1e-3 * scale, f"gradient of {name}"


def test_offset_gradient_stops_where_clamped():
    """Beyond a tap's reach the windowed offset gradient is 0 (the clip-pass
    indicator), while the exact one is not."""
    args, g = _case(*CASES[1])
    off = args[1]
    win = _plain_bwd(args, g, "windowed")[1]
    ex = _plain_bwd(args, g, "exact")[1]
    far = np.abs(off) > 3.5          # past the +/-2..3 px reach on that axis
    assert far.any() and np.all(win[far] == 0)
    assert np.abs(ex[far]).max() > 1e-3


@pytest.mark.parametrize("semantics", ["windowed", "exact"])
def test_function_on_cpu_routes_to_plain(semantics):
    """`deform_conv` on CPU tensors: the plain forward and the explicit
    plain backward, no kernel launch counted, and gradients reach all four
    inputs (the weight through its cast to x's type)."""
    args, g = _case(*CASES[2])
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    fwd, bwd = cuda_deform.launches, cuda_deform.bwd_launches
    out = cuda_deform.deform_conv(*t, semantics=semantics)
    out.backward(torch.from_numpy(g))
    assert (cuda_deform.launches, cuda_deform.bwd_launches) == (fwd, bwd)
    want_out = modulated_deform_conv2d_plain(*[torch.from_numpy(a) for a in args],
                                             semantics=semantics)
    torch.testing.assert_close(out.detach(), want_out, rtol=0, atol=0)
    want = _plain_bwd(args, g, semantics)
    for name, a, b in zip(NAMES, t, want):
        assert a.grad is not None and np.abs(a.grad.numpy()).max() > 0, name
        np.testing.assert_array_equal(a.grad.numpy(), b, err_msg=name)


def test_function_casts_inputs_to_x_type():
    """A bf16 x takes float32 offset, mask and weight (the weight stays a
    float32 parameter); the weight's gradient comes back in float32."""
    args, g = _case(*CASES[2])
    x = torch.from_numpy(args[0]).bfloat16().requires_grad_()
    rest = [torch.from_numpy(a).requires_grad_() for a in args[1:]]
    out = cuda_deform.deform_conv(x, *rest)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g).bfloat16())
    assert x.grad.dtype == torch.bfloat16
    assert all(r.grad.dtype == torch.float32 and torch.isfinite(r.grad).all() for r in rest)


@pytest.mark.parametrize("kernel,counter", [("deform_bwd", "bwd_launches"),
                                            ("deform_bwd_simt", "bwd_simt_launches")])
def test_bwd_cpu_route_uses_plain_and_counts_no_launch(kernel, counter):
    args, g = _case(*CASES[3])
    before = getattr(cuda_deform, counter)
    t = [torch.from_numpy(a) for a in args]
    got = getattr(cuda_deform, kernel)(*t, torch.from_numpy(g), "exact")
    assert getattr(cuda_deform, counter) == before
    for name, a, b in zip(NAMES, got, _plain_bwd(args, g, "exact")):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _split(t):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _three_terms(a, b):
    """a @ b as the kernel takes float32 operands: bf16 hi/lo of each,
    hi.hi + lo.hi + hi.lo summed in float32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + al @ bh + ah @ bl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_contractions_on_bf16_terms(dtype):
    """The tap gradient g . W^T (C 32 -> 32, 9 taps) and the weight gradient
    s^T . g over 4096 pixels: in float32 the three-term products stay within
    1e-4 of each result's largest value (the float32 limit the kernel is
    held to on the card); in bf16 the operands are bf16-exact: hi is the
    operand and the lo terms vanish, so one product is the float32 one."""
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.standard_normal((4096, 32)).astype(np.float32)).to(dtype).float()
    w = torch.from_numpy((rng.standard_normal((288, 32)) * 0.06).astype(np.float32))
    w = w.to(dtype).float()
    s = torch.from_numpy(rng.standard_normal((4096, 288)).astype(np.float32)).to(dtype).float()
    for a, b in ((g, w.T), (s.T, g)):
        want = a.double() @ b.double()
        if dtype == torch.float32:
            got = _three_terms(a, b)
            assert (got.double() - want).abs().max() <= 1e-4 * want.abs().max()
        else:
            assert all(torch.equal(_split(t)[0], t) and not _split(t)[1].any()
                       for t in (a, b))
