"""The five K1 variants' plain versions against their JAX prototypes on the
CPU, and the port's A/B tools and wrappers on the CPU.

The prototypes are functions of the repo-root A/B scripts
`tools/proto_deform_{bf16_fma,qxhoist,slot_skip,tapwalk}.py`, three of which
run TPU benchmarks when imported. They are never imported: `_load` parses a
script, keeps the named function definitions and runs them in a namespace
whose `pl.pallas_call` passes `interpret=True`, with the names they take from
`mgdt_yolo_tpu.ops.pallas_deform`. The CUDA kernels themselves are held
against these plain versions on the card by `chip_smoke.py`.

Inputs: the JAX tools' check shape (2, 16, 24, 8 -> 6), offsets U(-3, 3),
made with numpy from a seed and handed to both sides.

Tolerances: float32 2e-6 absolute, as `test_torch_deform.py` (both sides sum
in float32 in other orders); bf16 two bf16 roundings (2^-8 relative) of the
largest output, since each side rounds its float32 result once, and at most
`deform_variants.MISMATCH_LIMIT` of the elements different: V1's function
and K1's are within two roundings of each other, but differ in about half
of the elements. XLA on the CPU keeps bf16 products in float32 unless told
not to, which would turn V1's prototype into K1 with bf16 corner weights, so
V1's prototype runs in bf16 in a child process with
`--xla_allow_excess_precision=false`, rounding every bf16 operation as it is
written (V4's and V5's compute in float32 and round only their output).
"""
import ast
import functools
import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import mgdt_yolo_tpu.ops.pallas_deform as PD
from mgdt_yolo_tpu_torch.ops import cuda_deform_variants as cdv
from mgdt_yolo_tpu_torch.ops.deform import modulated_deform_conv2d_plain
from mgdt_yolo_tpu_torch.ops.deform_variants import (MISMATCH_LIMIT, deform_bf16_fma_plain,
                                                     windowed_plain)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ATOL_F32 = 2e-6
SHAPE = (2, 16, 24, 8, 6)


class _InterpretPallas(types.SimpleNamespace):
    """`jax.experimental.pallas` with every `pallas_call` in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        kwargs["interpret"] = True
        return pl.pallas_call(*args, **kwargs)


def _load(script, *names):
    """The named top-level functions of `tools/<script>`, without running
    the script."""
    path = ROOT / "tools" / script
    tree = ast.parse(path.read_text(), str(path))
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = dict(functools=functools, jax=jax, jnp=jnp, np=np, pl=_InterpretPallas(),
              pltpu=pltpu, K=PD.K, M=PD.M, RB=PD.RB, _fields=PD._fields,
              _pad_cf=PD._pad_cf, _tap_axis_weights=PD._tap_axis_weights)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


# (script, functions to load, the entry point)
PROTOTYPES = {
    "bf16_fma": ("proto_deform_bf16_fma.py", ("_kernel_bf16", "variant"), "variant"),
    "slot_skip": ("proto_deform_slot_skip.py", ("_kernel_skip", "variant"), "variant"),
    "tapwalk": ("proto_deform_tapwalk.py", ("_fields_tap", "_kernel_tap", "variant"),
                "variant"),
    "qxhoist": ("proto_deform_qxhoist.py", ("_kernel_fused_qxhoist", "deform_qxhoist"),
                "deform_qxhoist"),
    "cvt1": ("proto_deform_qxhoist.py", ("_kernel_fused_cvt1", "deform_cvt1"),
             "deform_cvt1"),
}


def _prototype(name):
    script, names, entry = PROTOTYPES[name]
    return _load(script, *names)[entry]


def _case(with_bias=False, seed=3):
    B, H, W, C, O = SHAPE
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = rng.uniform(-3, 3, (B, H, W, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((O,)).astype(np.float32) if with_bias else None
    return x, off, mask, w, bias


def _jax(fn, args, dtype):
    x, off, mask, w, bias = args
    ins = [jnp.asarray(a, dtype) for a in (x, off, mask, w)]
    extra = () if bias is None else (jnp.asarray(bias),)
    return np.asarray(fn(*ins, *extra)).astype(np.float32)


# the child process that runs a prototype in bf16: argv is the inputs'
# .npz, the output's .npy and the prototype's name in PROTOTYPES
_STRICT_BF16 = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, "tests")
from test_torch_deform_variants import _jax, _prototype
data = np.load(sys.argv[1])
args = [data[k] if k in data else None for k in ("x", "off", "mask", "w", "bias")]
np.save(sys.argv[2], _jax(_prototype(sys.argv[3]), args, jnp.bfloat16))
"""


def _jax_strict_bf16(name, args, tmp_path):
    """The prototype `name` in bf16 with every bf16 operation rounded."""
    x, off, mask, w, bias = args
    ins, out = tmp_path / "ins.npz", tmp_path / "out.npy"
    np.savez(ins, x=x, off=off, mask=mask, w=w, **({} if bias is None else {"bias": bias}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"}
    subprocess.run([sys.executable, "-c", _STRICT_BF16, str(ins), str(out), name],
                   cwd=ROOT, env=env, check=True, timeout=300)
    return np.load(out)


def _torch_args(args, dtype):
    x, off, mask, w, bias = args
    ins = [torch.from_numpy(a).to(dtype) for a in (x, off, mask, w)]
    return ins + ([] if bias is None else [torch.from_numpy(bias)])


def _within(got, want, dtype):
    """(largest |got - want|, its limit, share of elements that differ, its
    limit) as the module docstring states them."""
    if dtype == "float32":
        return np.abs(got - want).max(), ATOL_F32, 0.0, 1.0
    return (np.abs(got - want).max(), 2 * 2 ** -8 * np.abs(want).max(),
            float(np.mean(got != want)), MISMATCH_LIMIT)


def _assert_close(got, want, dtype):
    err, atol, share, limit = _within(got, want, dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert share <= limit, f"{share:.2%} of the elements differ, more than {limit:.0%}"


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the port's plain version of each prototype's function
PLAIN = {"bf16_fma": deform_bf16_fma_plain, "slot_skip": windowed_plain,
         "tapwalk": windowed_plain, "qxhoist": windowed_plain, "cvt1": windowed_plain}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["bf16_fma", "slot_skip", "tapwalk"])
def test_plain_matches_jax_prototype(name, dtype, tmp_path):
    args = _case()
    jdt, tdt = DTYPES[dtype]
    if dtype == "bfloat16" and name == "bf16_fma":
        want = _jax_strict_bf16(name, args, tmp_path)
    else:
        want = _jax(_prototype(name), args, jdt)
    ins = _torch_args(args, tdt)
    _assert_close(PLAIN[name](*ins).float().numpy(), want, dtype)
    if PLAIN[name] is not windowed_plain:
        # the control: K1's plain version must fall outside V1's limits
        err, atol, share, limit = _within(windowed_plain(*ins).float().numpy(), want, dtype)
        assert err > atol or share > limit


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("name", ["qxhoist", "cvt1"])
def test_plain_matches_jax_slab_prototype(name, with_bias):
    args = _case(with_bias)
    want = _jax(_prototype(name), args, jnp.float32)
    got = PLAIN[name](*_torch_args(args, torch.float32)).numpy()
    _assert_close(got, want, "float32")


def test_bf16_fma_rounding_shows():
    """V1 is not K1: with bf16 corner weights and products, its bf16 output
    differs from K1's plain version by more than 1e-3 on the same inputs,
    and in more than MISMATCH_LIMIT of the elements."""
    ins = _torch_args(_case(), torch.bfloat16)
    v1 = deform_bf16_fma_plain(*ins)
    k1 = modulated_deform_conv2d_plain(*ins, semantics="windowed")
    assert (v1.float() - k1.float()).abs().max().item() > 1e-3
    assert (v1 != k1).float().mean().item() > MISMATCH_LIMIT


TOOLS = ("proto_deform_bf16_fma", "proto_deform_qxhoist", "proto_deform_slot_skip",
         "proto_deform_tapwalk")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_quietly_and_checks_on_cpu(tool, capsys):
    mod = importlib.reload(importlib.import_module(f"mgdt_yolo_tpu_torch.tools.{tool}"))
    assert capsys.readouterr().out == ""
    before = dict(cdv.launches)
    assert mod.main(["check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(" ok") >= 2 and "FAIL" not in out
    assert cdv.launches == before


# every variant kernel: the five variants and the first designs of V2-V5
ALL_KERNELS = {**cdv.VARIANTS, **{simt: (fn, plain) for simt, fn, plain in
                                  cdv.FIRST_DESIGNS.values()}}


@pytest.mark.parametrize("kernel", list(ALL_KERNELS))
def test_wrapper_routes_cpu_to_plain_and_refuses_exact(kernel):
    fn, plain = ALL_KERNELS[kernel]
    ins = _torch_args(_case(), torch.float32)
    before = cdv.launches[kernel]
    torch.testing.assert_close(fn(*ins), plain(*ins), rtol=0, atol=0)
    assert cdv.launches[kernel] == before
    with pytest.raises(ValueError):
        fn(*ins, semantics="exact")
