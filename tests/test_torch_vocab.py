"""The rest of `parse_model`'s vocabulary in the port against the JAX
package on the CPU: the 13 types no YAML of the repo uses (`DWConv`,
`Conv2`, `ConvTranspose` with BatchNorm, `DWConvTranspose2d`, `Focus`,
`GhostConv`, `RepVGGBlock`, `C1`, `C3x`, `C3TR`, `GhostBottleneck`,
`C3Ghost`, `BottleneckCSP`), RT-DETR's `HGStem`, `HGBlock` and `RepC3`
with the `LightConv` and `RepConv` they are built of, and a config that
uses all of them as one model.

Each module starts from JAX's variables with randomised norm statistics,
scales and biases (`test_torch_model._randomize`), carried across by
`weights.py`, on a non-square NHWC input (odd sizes where a stride meets
them), and runs unfused and fused (`nn/fuse.py`: Conv+BN, Conv2's 1x1 into
its centre tap, ConvTranspose's norm, the RepConv / RepVGGBlock branches
merged into one conv). Tolerances: float32 within 1e-4 of the largest
magnitude (at least 1) for the modules and the whole config (XLA and
PyTorch sum their products in other orders; the fold rounds its products
once more), float64 within 1e-7 of it for the modules run in float64 on
both sides.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.nn.modules import block as JB
from mgdt_yolo_tpu.nn.modules import conv as JC
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.nn.tasks import fast_init
from mgdt_yolo_tpu_torch.models.vocab import ITEM_17
from mgdt_yolo_tpu_torch.models.vocab import VOCABULARY as VOCAB
from mgdt_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from mgdt_yolo_tpu_torch.nn.modules import block as B
from mgdt_yolo_tpu_torch.nn.modules import conv as C
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel, parse_model
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, flax_keys,
                                         load_jax_variables, load_state)
from test_torch_model import _nest, _randomize
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL32, RTOL64 = 1e-4, 1e-7

# name -> (JAX module, port module, input channels, input (h, w))
MODULES = {
    "DWConv": (lambda: JC.DWConv(12, 3, 2, act=False), lambda: C.DWConv(8, 12, 3, 2, act=False),
               8, (9, 13)),
    "DWConv_act": (lambda: JC.DWConv(8, 5), lambda: C.DWConv(8, 8, 5), 8, (9, 13)),
    "LightConv": (lambda: JC.LightConv(12, 5), lambda: C.LightConv(8, 12, 5), 8, (9, 13)),
    "Conv2": (lambda: JC.Conv2(12, 3, 1), lambda: C.Conv2(8, 12, 3, 1), 8, (9, 13)),
    "Conv2_s2": (lambda: JC.Conv2(12, 5, 2), lambda: C.Conv2(8, 12, 5, 2), 8, (9, 13)),
    "RepConv": (lambda: JC.RepConv(12), lambda: C.RepConv(8, 12), 8, (9, 13)),
    "RepConv_identity": (lambda: JC.RepConv(8, bn_identity=True),
                         lambda: C.RepConv(8, 8, bn_identity=True), 8, (9, 13)),
    "RepVGGBlock": (lambda: JC.RepVGGBlock(8), lambda: C.RepVGGBlock(8, 8), 8, (9, 13)),
    "RepVGGBlock_s2": (lambda: JC.RepVGGBlock(12, 3, 2), lambda: C.RepVGGBlock(8, 12, 3, 2),
                       8, (9, 13)),
    "ConvTranspose": (lambda: JC.ConvTranspose(6, 2, 2, 0),
                      lambda: C.ConvTranspose(4, 6, 2, 2, 0, bn=True, act=True), 4, (5, 7)),
    "DWConvTranspose2d": (lambda: JC.DWConvTranspose2d(6, 2, 2),
                          lambda: C.DWConvTranspose2d(4, 6, 2, 2), 4, (5, 7)),
    "DWConvTranspose2d_k3": (lambda: JC.DWConvTranspose2d(8, 3, 2, 1),
                             lambda: C.DWConvTranspose2d(8, 8, 3, 2, 1), 8, (5, 7)),
    "Focus": (lambda: JC.Focus(12, 3), lambda: C.Focus(3, 12, 3), 3, (10, 14)),
    "GhostConv": (lambda: JC.GhostConv(12, 3, 2), lambda: C.GhostConv(8, 12, 3, 2), 8, (9, 13)),
    "C1": (lambda: JB.C1(12, n=2), lambda: B.C1(8, 12, n=2), 8, (9, 13)),
    "C3x": (lambda: JB.C3x(16, n=2), lambda: B.C3x(16, 16, n=2), 16, (9, 13)),
    "C3TR": (lambda: JB.C3TR(16, n=2), lambda: B.C3TR(8, 16, n=2), 8, (6, 10)),
    "GhostBottleneck": (lambda: JB.GhostBottleneck(16), lambda: B.GhostBottleneck(16, 16),
                        16, (9, 13)),
    "GhostBottleneck_s2": (lambda: JB.GhostBottleneck(24, 3, 2),
                           lambda: B.GhostBottleneck(16, 24, 3, 2), 16, (9, 13)),
    "C3Ghost": (lambda: JB.C3Ghost(16, n=2), lambda: B.C3Ghost(8, 16, n=2), 8, (9, 13)),
    "BottleneckCSP": (lambda: JB.BottleneckCSP(16, n=2), lambda: B.BottleneckCSP(8, 16, n=2),
                      8, (9, 13)),
    "RepC3": (lambda: JB.RepC3(16, n=2), lambda: B.RepC3(8, 16, n=2), 8, (9, 13)),
    "HGStem": (lambda: JB.HGStem(8, 16), lambda: B.HGStem(3, 8, 16), 3, (18, 26)),
    "HGBlock": (lambda: JB.HGBlock(8, 16, 3, n=2), lambda: B.HGBlock(12, 8, 16, 3, 2),
                12, (9, 13)),
    "HGBlock_light_shortcut": (lambda: JB.HGBlock(8, 16, 5, n=3, lightconv=True, shortcut=True),
                               lambda: B.HGBlock(16, 8, 16, 5, 3, True, True), 16, (9, 13)),
}


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= rel * scale, f"{what}: max |diff| {err:.3e}, scale {scale:.3e}"


def _run_port(m, x):
    with torch.no_grad():
        return m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


_CASES = {}


def _case(name):
    """(input, JAX's randomised variables, JAX's float32 output), once."""
    if name not in _CASES:
        jf, _, c1, (h, w) = MODULES[name]
        x = np.random.default_rng(1).standard_normal((2, h, w, c1)).astype(np.float32)
        jm = jf()
        # JAX's own shape-only init (flax's random initialisers cost seconds to compile)
        flat = _randomize(fast_init(jm, 0, jnp.asarray(x)), seed=2)
        want = np.asarray(jax.jit(jm.apply)(_nest(flat), jnp.asarray(x)))
        _CASES[name] = (x, _on_layer(name, flat), want)
    return _CASES[name]


def _on_layer(name, flat):
    """A standalone `DWConvTranspose2d`'s variables as a graph layer holds
    them (`params.model_0.kernel`): its kernel sits on the layer itself,
    which is how `weights.py` knows it for a transposed one."""
    if not name.startswith("DWConvTranspose2d"):
        return flat
    return {k.replace("params.", "params.model_0.", 1): v for k, v in flat.items()}


def _port(name):
    pm = MODULES[name][1]()
    if name.startswith("DWConvTranspose2d"):
        pm = torch.nn.ModuleDict({"model_0": pm})
        pm.forward = pm["model_0"].forward
    return pm


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_unfused_and_fused(name):
    """The port's module on JAX's variables gives JAX's output, then again
    after `fuse_conv_bn`; its flax names are JAX's both ways."""
    x, flat, want = _case(name)
    pm = _port(name)
    assert set(flax_keys(pm).values()) == set(flat)
    load_state(pm, load_jax_variables(flat))
    pm.eval()
    for k, v in export_variables(pm).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    _close(_run_port(pm, x), want, RTOL32, f"{name} unfused")
    n = fuse_conv_bn(pm)
    has_norm = any(k.startswith("batch_stats.") for k in flat)
    assert (n > 0) == has_norm, (name, n)
    _close(_run_port(pm, x), want, RTOL32, f"{name} fused")
    if name.startswith(("RepConv", "RepVGGBlock")):  # the branches merged into one conv
        assert all(p is None for p in (getattr(pm, "conv2", None), getattr(pm, "rbr_1x1", None)))


@pytest.mark.parametrize("name", ["Conv2", "RepConv_identity", "RepVGGBlock", "DWConvTranspose2d",
                                  "HGStem", "C3TR", "ConvTranspose"])
def test_module_matches_jax_in_float64(name):
    """JAX's module and the port's in float64, unfused and fused."""
    x, flat, _ = _case(name)
    jf = MODULES[name][0]
    with jax.enable_x64(True):
        jm = jf().clone(dtype=jnp.float64)
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(flat))
        if name.startswith("DWConvTranspose2d"):
            v = {"params": v["params"]["model_0"]}
        want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x, jnp.float64)))
    pm = _port(name)
    load_state(pm, load_jax_variables(flat))
    pm = pm.double().eval()
    x64 = x.astype(np.float64)
    _close(_run_port(pm, x64), want, RTOL64, f"{name} float64")
    fuse_conv_bn(pm)  # the fold's products in float32: the float32 limit
    _close(_run_port(pm, x64), want, RTOL32, f"{name} float64 fused")


def test_dwconv_transpose_kernel_is_flipped_and_grouped():
    """JAX keeps one (k, k, c1, c2 / g) kernel on the layer; the port's
    grouped weight (c1, c2 / g, k, k) is that kernel with both spatial axes
    flipped, groups gcd(c1, c2), and comes back unchanged."""
    _, flat, _ = _case("DWConvTranspose2d")
    pm = _port("DWConvTranspose2d")
    conv = pm["model_0"]
    assert conv.groups == math.gcd(4, 6) == 2 and conv.weight.shape == (4, 3, 2, 2)
    load_state(pm, load_jax_variables(flat))
    kernel = flat["params.model_0.kernel"]
    assert kernel.shape == (2, 2, 4, 3)
    np.testing.assert_array_equal(conv.weight.detach().numpy()[:, :, 0, 1], kernel[1, 0])
    np.testing.assert_array_equal(export_variables(pm)["params.model_0.kernel"], kernel)


def test_hgstem_pool_is_the_inner_window():
    """JAX pools the padded stem with a one-sided -inf pad and crops to
    stem2b's size: only windows inside the map survive, so the pad never
    wins, even on negative activations (stem1's ReLU output is >= 0; here
    the pool is fed negatives directly)."""
    y = -np.abs(np.random.default_rng(0).standard_normal((1, 7, 9, 4))).astype(np.float32) - 1
    yp = np.pad(y, ((0, 0), (0, 1), (0, 1), (0, 0)))
    want = np.asarray(jax.lax.reduce_window(jnp.asarray(yp), -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                            (1, 1, 1, 1), [(0, 0), (0, 1), (0, 1), (0, 0)]))
    want = want[:, :7, :9]
    got = torch.nn.functional.max_pool2d(torch.from_numpy(yp).permute(0, 3, 1, 2), 2, 1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# RT-DETR's backbone blocks in a detection model
VOCAB_STEM = {
    "nc": 3,
    "backbone": [
        [-1, 1, "HGStem", [8, 16]],                         # 0  /4
        [-1, 2, "HGBlock", [8, 24, 3]],                     # 1
        [-1, 1, "DWConv", [32, 3, 2, 1, False]],            # 2  /8
        [-1, 3, "HGBlock", [8, 32, 5, True, True]],         # 3
    ],
    "head": [[[1, 3], 1, "Detect", ["nc"]]],
}


def _norm(a):
    return tuple(_norm(x) for x in a) if isinstance(a, (list, tuple)) else a


@pytest.mark.parametrize("cfg", [VOCAB, VOCAB_STEM], ids=["item17", "hgnet"])
def test_vocabulary_config_matches_jax(cfg):
    """The config builds with JAX's specs, head strides (JAX's probe run
    against the port's arithmetic), flax names and parameter count, and its
    eval forward (decoded output and raw maps) holds JAX's on a 64 x 96
    input, unfused and fused."""
    if cfg is VOCAB:
        assert set(ITEM_17) <= {row[2] for row in cfg["backbone"] + cfg["head"]}
    jm = JaxDetectionModel(dict(cfg))
    pm = DetectionModel(dict(cfg), device="cpu")
    assert pm.stride == jm.stride
    for p, j in zip(pm.specs, jm.specs):
        assert (p.i, p.f, p.name, p.n, p.c2) == (j.i, j.f, j.name, j.n, j.c2), p
        assert _norm(p.args) == _norm(j.args), p
    assert set(flax_keys(pm).values()) == set(flatten_variables(jax.device_get(jm.variables)))
    assert sum(p.numel() for p in pm.parameters()) == jm.num_params()
    start = _randomize(jm.variables, seed=3)
    load_state(pm, load_jax_variables(start))
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.model.apply(v, x, train=False))(_nest(start), jnp.asarray(x))
    w_leaves = [np.asarray(want[0])] + [np.asarray(w) for w in want[1]]
    for fused in (False, True):
        if fused:
            pm.fuse()
        with torch.no_grad():
            got = pm(torch.from_numpy(x))
        g_leaves = [got[0].numpy()] + [g.numpy() for g in got[1]]
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            _close(g, w, RTOL32, f"{'fused' if fused else 'unfused'} {w.shape}")


def test_unknown_type_raises_and_parse_keeps_jaxs_arithmetic():
    """A type outside JAX's vocabulary raises KeyError; HGBlock's repeat
    count goes in as its argument 4 and the row then runs once; RT-DETR's
    strides (HGStem /4, DWConv /2) and widths (taken as given) are JAX's."""
    with pytest.raises(KeyError):
        parse_model({"nc": 2, "backbone": [[-1, 1, "Bogus", [8]]], "head": []})
    specs = parse_model(VOCAB_STEM)[0]
    assert specs[1].args == (16, 8, 24, 3, 2) and specs[1].n == 1
    assert specs[3].args == (32, 8, 32, 5, 3, True, True)
    assert [s.stride for s in specs[:4]] == [4, 4, 8, 8]
