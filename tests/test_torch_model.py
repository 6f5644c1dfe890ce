"""The port's modules and the whole flagship model against the JAX package
(CPU, float32), with weights carried across by `weights.py`.

Per module: the flax module is initialised, its norm statistics, scales and
biases are randomised (so BatchNorm is no identity), and the same variables
go into the port's module. Whole model: the committed
`weights/mgdt_n_synth.npz` (windowed semantics) at 64 px.

Tolerances: float32 convolutions, norms and matrix products accumulate in
another order in XLA and in PyTorch; after ~60 layers raw maps of magnitude
~10 agree to a few 1e-6 (observed) and are held to 1e-4. Decoded boxes are
in input pixels (DFL expectations times the stride 8), held to 5e-4.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from mgdt_yolo_tpu.nn.modules import block as JB
from mgdt_yolo_tpu.nn.modules import conv as JC
from mgdt_yolo_tpu.nn.modules import head as JH
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils import yaml_load
from mgdt_yolo_tpu_torch.data.synthetic import synthetic_batch
from mgdt_yolo_tpu_torch.models.mspa_c2f_gd_tood_yolov8 import CONFIG
from mgdt_yolo_tpu_torch.nn.modules import block as B
from mgdt_yolo_tpu_torch.nn.modules import conv as C
from mgdt_yolo_tpu_torch.nn.modules import head as H
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.weights import flatten_variables, load_jax_variables, load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "weights" / "mgdt_n_synth.npz"
ATOL_MODULE = 1e-4
ATOL_RAW = 1e-4
ATOL_DECODED = 5e-4


def _randomize(variables, seed=0):
    """Random norm statistics, scales and biases; kernels keep their init."""
    rng = np.random.default_rng(seed)
    flat = flatten_variables(jax.device_get(variables))
    out = {}
    for key, v in flat.items():
        leaf = key.rsplit(".", 1)[-1]
        v = np.asarray(v, np.float32)
        if leaf == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif leaf in ("bias", "mean", "gamma", "beta", "reduction_bias"):
            v = rng.standard_normal(v.shape) * 0.1
        out[key] = v.astype(np.float32)
    return out


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _pair(jmod, tmod, inputs, seed=0):
    """Init the flax module on `inputs` (NHWC arrays), carry randomised
    variables into the port module; returns (jax apply fn, port module)."""
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(seed), *inputs)
    flat = _randomize(variables, seed)
    load_state(tmod, load_jax_variables(flat))
    tmod.eval()
    nested = _nest(flat)
    return jax.jit(lambda *xs: jmod.apply(nested, *xs)), tmod


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _maps(shapes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _check_single(jmod, tmod, shape, seed=0):
    (x,) = _maps([shape], seed + 1)
    run, tmod = _pair(jmod, tmod, [jnp.asarray(x)], seed)
    want = np.asarray(run(jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MODULE)


def test_conv():
    _check_single(JC.Conv(16, 3, 2), C.Conv(8, 16, 3, 2), (2, 16, 16, 8))


@pytest.mark.parametrize("hw", [(16, 16), (15, 13)], ids=["even", "odd"])
def test_mspa_c2f(hw):
    _check_single(JB.MSPA_C2f(32, 32, n=2, shortcut=True),
                  B.MSPA_C2f(32, 32, n=2, shortcut=True), (2, *hw, 32))


def test_sppf():
    _check_single(JB.SPPF(32, 5), B.SPPF(32, 32, 5), (2, 8, 8, 32))


def test_c2f():
    _check_single(JB.C2f(32, n=1), B.C2f(48, 32, n=1), (2, 8, 8, 48))


def test_ifm():
    _check_single(JB.IFM((16, 8)), B.IFM(40, (16, 8)), (2, 8, 8, 40))


def test_simfusion_4in():
    xs = _maps([(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64)])
    want = np.asarray(JB.SimFusion_4in().apply({}, [jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = _nhwc(B.SimFusion_4in()([_nchw(x) for x in xs]))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MODULE)


def test_simfusion_3in():
    xs = _maps([(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 16)])
    run, tmod = _pair(JB.SimFusion_3in((8, 16, 16), 16), B.SimFusion_3in((8, 16, 16), 16),
                      [[jnp.asarray(x) for x in xs]])
    want = np.asarray(run([jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = _nhwc(tmod([_nchw(x) for x in xs]))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MODULE)


@pytest.mark.parametrize("g_hw", [4, 16], ids=["upsample", "pool"])
def test_injection(g_hw):
    xs = _maps([(2, 8, 8, 16), (2, g_hw, g_hw, 24)])
    run, tmod = _pair(JB.InjectionMultiSum_Auto_pool(32, (16, 8), 1),
                      B.InjectionMultiSum_Auto_pool(16, 32, (16, 8), 1),
                      [[jnp.asarray(x) for x in xs]])
    want = np.asarray(run([jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = _nhwc(tmod([_nchw(x) for x in xs]))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MODULE)


def test_tood_head():
    (x,) = _maps([(2, 8, 8, 32)])
    run, tmod = _pair(JH.TOODHead(2, 32, (32,), strides=(8,)),
                      H.TOODHead(2, 32, (32,), (8,)), [[jnp.asarray(x)]])
    want_dec, want_feats = run([jnp.asarray(x)])
    with torch.no_grad():
        got_dec, got_feats = tmod([_nchw(x)])
    np.testing.assert_allclose(_nhwc(got_feats[0]), np.asarray(want_feats[0]),
                               rtol=0, atol=ATOL_MODULE)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), rtol=0,
                               atol=ATOL_DECODED)


# ---------------------------------------------------------------------------
# the whole flagship from the committed weights
# ---------------------------------------------------------------------------

def _jax_variables():
    with np.load(str(NPZ)) as flat:
        return _nest({k: flat[k] for k in flat.files})


@pytest.fixture(scope="module")
def flagship():
    """JAX model (windowed pin) and the port, both from the npz, and a
    64 px input batch."""
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.variables = _jax_variables()
    jm.set_deform_semantics("windowed")
    predict = jax.jit(lambda v, x: jm.model.apply(v, x, train=False))
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    pm = DetectionModel.from_npz(NPZ, device="cpu")
    return jm, predict, pm, x


def _compare(decoded, feats, want_dec, want_feats):
    for got, want in zip(feats, want_feats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_RAW)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(want_dec), rtol=0,
                               atol=ATOL_DECODED)


def test_flagship_matches_jax(flagship):
    jm, predict, pm, x = flagship
    assert pm.deform_semantics == "windowed" and pm.stride == (8,)
    want_dec, want_feats = predict(jm.variables, jnp.asarray(x))
    with torch.no_grad():
        decoded, feats = pm(torch.from_numpy(x))
    assert decoded.shape == (2, 4 + 2, 64) and feats[0].shape == (2, 8, 8, 66)
    _compare(decoded, feats, want_dec, want_feats)


def test_fused_matches_unfused_and_jax_fused(flagship):
    jm, predict, pm, x = flagship
    fused = DetectionModel.from_npz(NPZ, device="cpu").fuse()
    assert fused.n_fused == 47
    with torch.no_grad():
        dec_u, feats_u = pm(torch.from_numpy(x))
        dec_f, feats_f = fused(torch.from_numpy(x))
    _compare(dec_f, feats_f, dec_u.numpy(), [f.numpy() for f in feats_u])
    jax_vars, n = jax_fuse(jm.variables)
    assert n == 47
    want_dec, want_feats = predict(jax_vars, jnp.asarray(x))
    _compare(dec_f, feats_f, want_dec, want_feats)


@pytest.mark.parametrize("imgsz,batch", [(320, 2), (640, 1)], ids=["320px-b2", "640px-b1"])
def test_flagship_matches_jax_at_training_size(flagship, imgsz, batch):
    """320 px (the weights' training size, a 40x40 DCN map) at b2 and 640
    px (the main path's size, an 80x80 DCN map) at b1, float32, at the
    file's limits (raw maps `ATOL_RAW`, decoded `ATOL_DECODED`)."""
    jm, predict, pm, _ = flagship
    x = synthetic_batch(batch, imgsz).astype(np.float32) / 255.0
    want_dec, want_feats = predict(jm.variables, jnp.asarray(x))
    with torch.no_grad():
        decoded, feats = pm(torch.from_numpy(x))
    _compare(decoded, feats, want_dec, want_feats)


def test_flagship_bf16_fused_near_jax(flagship):
    """The main path's dtype policy (fused, bf16, 320 px) against JAX's.

    The two round to bf16 at different places, so this is loose: raw maps
    (magnitude ~9, where a bf16 step is 0.0625) within 0.25 at most and
    0.01 on average; class scores within 0.05; boxes within 2 px. A wrong
    dtype policy (a bf16 softmax, a bf16 resampling product) exceeds it.
    """
    jm, _, _, _ = flagship
    x = synthetic_batch(2, 320).astype(np.float32) / 255.0
    jax_vars, _ = jax_fuse(jm.variables)
    bf16 = jm.model.clone(dtype=jnp.bfloat16)
    want_dec, want_feats = jax.jit(lambda v, x: bf16.apply(v, x, train=False))(
        jax_vars, jnp.asarray(x))
    pm = DetectionModel.from_npz(NPZ, device="cpu").fuse().to(torch.bfloat16)
    with torch.no_grad():
        decoded, feats = pm(torch.from_numpy(x))
    raw = np.abs(feats[0].float().numpy() - np.asarray(want_feats[0]).astype(np.float32))
    assert raw.max() <= 0.25 and raw.mean() <= 0.01, (raw.max(), raw.mean())
    want_dec = np.asarray(want_dec)
    assert decoded.dtype == torch.float32
    np.testing.assert_allclose(decoded[:, 4:].numpy(), want_dec[:, 4:], rtol=0, atol=0.05)
    np.testing.assert_allclose(decoded[:, :4].numpy(), want_dec[:, :4], rtol=0, atol=2.0)


def test_config_literal_matches_yaml():
    yaml_cfg = yaml_load(ROOT / "mgdt_yolo_tpu/models/v8/mspa_c2f_gd_tood_yolov8.yaml")
    assert CONFIG == yaml_cfg


def test_scales_build():
    """Every scale of the config builds with the JAX package's channel
    arithmetic (checked on the widest layer of the neck)."""
    for scale, width in (("n", 0.25), ("s", 0.5), ("x", 1.25)):
        m = DetectionModel(scale=scale, device="cpu")
        assert m.model_12.conv.out_channels == int(256 * width)


def test_unported_module_raises():
    """`Focus`, once refused, now builds (with the rest of JAX's
    vocabulary, `tests/test_torch_vocab.py`); a type outside JAX's
    vocabulary still raises KeyError."""
    cfg = {"nc": 2, "backbone": [[-1, 1, "Focus", [64, 3]]],
           "head": [[[0], 1, "Detect", ["nc"]]]}
    m = DetectionModel(cfg, device="cpu")
    assert isinstance(m.model_0, C.Focus) and m.stride == (2,)
    bogus = {"nc": 2, "backbone": [[-1, 1, "Bogus", [64, 3]]], "head": []}
    with pytest.raises(KeyError):
        DetectionModel(bogus, device="cpu")
