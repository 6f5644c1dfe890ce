"""The seven other models of the ablation matrix in the port against the JAX
package (CPU, float32): the modules they add (nearest upsampling, `Concat`,
`Upsample`, the reg_max-4 `Detect` head), their config literals, and each
whole model, unfused and fused, from JAX's seeded variables with randomised
norm statistics, scales and biases carried across by `weights.py`.

The JAX models are pinned to the windowed DCN (a fresh one picks a path by
platform), and the thead model once more to the exact one.

Tolerances, each with its reason:

* nearest upsampling and `Concat`: exact (copies of the same values);
* bilinear `Upsample`: 1e-6 (the same interpolation matrices contracted in
  another order);
* modules: 1e-4, as `tests/test_torch_model.py` holds the flagship's;
* whole models at 64 px: raw maps 1e-4 of their magnitude (at least 1), as
  the flagship's raw maps (float32 convolutions and norms summed in another
  order by XLA and PyTorch; observed at most 2e-6); decoded boxes are DFL
  expectations times the stride, so the flagship's 5e-4 at stride 8 scales
  to 2e-3 at the largest stride, 32; class scores are in [0, 1] and held to
  the same.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from mgdt_yolo_tpu.nn.modules import conv as JC
from mgdt_yolo_tpu.nn.modules import head as JH
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.ops import common as jcommon
from mgdt_yolo_tpu.utils import yaml_load
from mgdt_yolo_tpu_torch.models import CONFIGS, FLAGSHIP, load_config
from mgdt_yolo_tpu_torch.models.ablation import CONFIGS as ABLATION
from mgdt_yolo_tpu_torch.nn.modules import conv as C
from mgdt_yolo_tpu_torch.nn.modules import head as H
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.ops import boxes, common
from mgdt_yolo_tpu_torch.weights import load_jax_variables, load_state
from test_torch_model import _maps, _nchw, _nest, _nhwc, _pair, _randomize
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
YAMLS = ROOT / "mgdt_yolo_tpu" / "models" / "v8"
# the eight variants of the reference's ablation script (tools/train_ablation.py)
VARIANTS = {"baseline": "yolov8.yaml", "m": "mspa_c2f_yolov8.yaml",
            "t": "thead_yolov8.yaml", "mt": "mspa_c2f_thead_yolov8.yaml",
            "gd": "gd_yolov8.yaml", "mgd": "mspa_c2f_gd_yolov8.yaml",
            "gdt": "gd_thead_yolov8.yaml", "mgdt": FLAGSHIP}
# each model's head strides, reg_max and Conv+BN pairs (JAX's count)
SHAPES = {"yolov8.yaml": ((8, 16, 32), 4, 57), "mspa_c2f_yolov8.yaml": ((8, 16, 32), 4, 65),
          "thead_yolov8.yaml": ((16,), 16, 45), "mspa_c2f_thead_yolov8.yaml": ((16,), 16, 53),
          "gd_yolov8.yaml": ((8,), 4, 43), "mspa_c2f_gd_yolov8.yaml": ((8,), 4, 51),
          "gd_thead_yolov8.yaml": ((8,), 16, 39), FLAGSHIP: ((8,), 16, 47)}
ATOL_MODULE = 1e-4
RTOL_RAW = 1e-4
ATOL_DECODED = 5e-4 * 32 / 8


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_nearest_matches_jax(scale):
    (x,) = _maps([(2, 5, 7, 3)])
    want = np.asarray(jcommon.upsample_nearest(jnp.asarray(x), scale))
    got = _nhwc(common.upsample_nearest(_nchw(x), scale))
    np.testing.assert_array_equal(got, want)


def test_concat_matches_jax():
    xs = _maps([(2, 4, 4, 3), (2, 4, 4, 5), (2, 4, 4, 1)])
    want = np.asarray(JC.Concat().apply({}, [jnp.asarray(x) for x in xs]))
    got = _nhwc(C.Concat()([_nchw(x) for x in xs]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,scale", [("nearest", 2), ("bilinear", 2), ("bilinear", 3)])
def test_upsample_matches_jax(mode, scale):
    (x,) = _maps([(2, 5, 6, 4)], seed=3)
    want = np.asarray(JC.Upsample(scale=scale, mode=mode).apply({}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(C.Upsample(scale, mode)(_nchw(x)))
    atol = 0 if mode == "nearest" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_upsample_refuses_other_modes():
    with pytest.raises(KeyError):
        C.Upsample(2, "bicubic")


@pytest.mark.parametrize("nc,ch", [(2, (32, 64, 96)), (80, (64,))], ids=["3-levels", "nc80"])
def test_detect_matches_jax(nc, ch):
    """The head on one map per level, raw maps and decoded output."""
    strides = (8, 16, 32)[:len(ch)]
    xs = _maps([(2, 64 // s, 64 // s, c) for s, c in zip(strides, ch)])
    run, tmod = _pair(JH.Detect(nc, ch, strides=strides), H.Detect(nc, ch, strides),
                      [[jnp.asarray(x) for x in xs]])
    assert tmod.reg_max == 4 and tmod.cv2_0_2.out_channels == 16
    want_dec, want_feats = run([jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got_dec, got_feats = tmod([_nchw(x) for x in xs])
    for got, want in zip(got_feats, want_feats):
        assert got.shape[1] == nc + 16
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=ATOL_MODULE)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), rtol=0,
                               atol=ATOL_DECODED)


def test_decode_without_dfl_matches_jax():
    """reg_max 1: the box channels are the ltrb distances themselves."""
    feats = _maps([(2, 4, 4, 4 + 3), (2, 2, 2, 4 + 3)], seed=5)
    want = np.asarray(JH.decode_detections([jnp.asarray(f) for f in feats], (8, 16), 3, 1))
    got = H.decode_detections([_nchw(f) for f in feats], (8, 16), 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_literal_matches_yaml(name):
    assert CONFIGS[name] == yaml_load(YAMLS / name)


def test_load_config_reads_names_as_jax():
    """A scale letter picks the scale and is kept; the literal stays as it is."""
    d = load_config("yolov8s.yaml")
    assert d["scale"] == "s" and d["yaml_file"] == "yolov8s.yaml"
    d["nc"] = 3
    assert CONFIGS["yolov8.yaml"]["nc"] == 80
    assert load_config(YAMLS / "thead_yolov8.yaml")["yaml_file"] == "thead_yolov8.yaml"
    with pytest.raises(KeyError):
        load_config("yolov8-p2.yaml")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_variant_builds(variant):
    """Each name of the ablation script builds at nc=2 with JAX's head
    strides and reg_max; at 640 px the three-level models have 8400
    anchors."""
    name = VARIANTS[variant]
    m = DetectionModel(name, nc=2, device="cpu")
    strides, reg_max, _ = SHAPES[name]
    assert (m.stride, m.reg_max, m.nc, m.model_yaml) == (strides, reg_max, 2, name)
    shapes = [(640 // s, 640 // s) for s in m.stride]
    assert len(boxes.make_anchors(shapes, m.stride)[0]) == \
        {8: 6400, 16: 1600}.get(max(strides), 8400)


def test_scale_letter_builds_that_scale():
    m = DetectionModel("yolov8s.yaml", nc=2, device="cpu")
    assert m.model_yaml == "yolov8s.yaml" and m.model_2.cv1.conv.out_channels == 64


# ---------------------------------------------------------------------------
# whole models against JAX
# ---------------------------------------------------------------------------

_MODELS = {}


def _model(name):
    """The JAX model (nc=2, windowed pin), its randomised variables, the
    port holding them, a jitted eval forward, and a 64 px batch; built
    once per config."""
    if name not in _MODELS:
        jm = JaxDetectionModel(name, nc=2)
        jm.set_deform_semantics("windowed")
        flat = _randomize(jm.variables, seed=1)
        pm = DetectionModel(name, nc=2, device="cpu")
        load_state(pm, load_jax_variables(flat))
        predict = jax.jit(lambda v, x: jm.model.apply(v, x, train=False))
        x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
        _MODELS[name] = (jm, _nest(flat), pm, predict, x)
    return _MODELS[name]


def _compare(decoded, feats, want_dec, want_feats, strides):
    assert len(feats) == len(want_feats) == len(strides)
    for got, want, s in zip(feats, want_feats, strides):
        want = np.asarray(want)
        assert got.shape == want.shape and got.shape[1] == 64 // s
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL_RAW * scale)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(want_dec), rtol=0,
                               atol=ATOL_DECODED)


@pytest.mark.parametrize("name", sorted(ABLATION))
def test_model_matches_jax(name):
    jm, variables, pm, predict, x = _model(name)
    assert (pm.stride, pm.reg_max) == (jm.stride, jm.reg_max) == SHAPES[name][:2]
    want_dec, want_feats = predict(variables, jnp.asarray(x))
    with torch.no_grad():
        decoded, feats = pm(torch.from_numpy(x))
    assert decoded.shape == (2, 4 + 2, sum((64 // s) ** 2 for s in pm.stride))
    _compare(decoded, feats, want_dec, want_feats, pm.stride)


@pytest.mark.parametrize("name", sorted(ABLATION))
def test_fused_model_matches_jax_fused(name):
    jm, variables, pm, predict, x = _model(name)
    fused = DetectionModel(name, nc=2, device="cpu")
    fused.load_state_dict(pm.state_dict())
    fused.fuse()
    jax_vars, n = jax_fuse(variables)
    assert fused.n_fused == n == SHAPES[name][2]
    want_dec, want_feats = predict(jax_vars, jnp.asarray(x))
    with torch.no_grad():
        decoded, feats = fused(torch.from_numpy(x))
    _compare(decoded, feats, want_dec, want_feats, pm.stride)


def test_thead_exact_semantics_matches_jax():
    """The thead model with both sides pinned to the exact DCN, at 128 px
    (an 8x8 map at stride 16, so offsets reach past the border)."""
    name = "thead_yolov8.yaml"
    jm, variables, pm, _, _ = _model(name)
    jm.set_deform_semantics("exact")
    try:
        x = np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
        want_dec, want_feats = jax.jit(lambda v, x: jm.model.apply(v, x, train=False))(
            variables, jnp.asarray(x))
    finally:
        jm.set_deform_semantics("windowed")
    pm.set_deform_semantics("exact")
    try:
        with torch.no_grad():
            decoded, feats = pm(torch.from_numpy(x))
    finally:
        pm.set_deform_semantics("windowed")
    assert feats[0].shape == (2, 8, 8, 2 + 64)
    for got, want in zip(feats, want_feats):
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=RTOL_RAW * scale)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(want_dec), rtol=0,
                               atol=ATOL_DECODED)


@pytest.mark.parametrize("name", sorted(ABLATION))
def test_head_prior_biases_match_jax(name):
    """A new model's head biases are JAX's priors: per `Detect` level 1 for
    the box branch and log(5 / nc / (640 / stride)^2) for the class branch;
    TOOD's at its hardcoded stride 16."""
    jm = _model(name)[0]
    pm = DetectionModel(name, nc=2, device="cpu")
    head = f"model_{pm.specs[-1].i}"
    want = jm.variables["params"][head]
    got = dict(getattr(pm, head).named_parameters())
    names = ["cv2", "cv3"] if jm.head_name == "TOODHead" else \
        [f"cv{b}_{i}_2" for i in range(len(pm.stride)) for b in (2, 3)]
    for n in names:
        np.testing.assert_allclose(got[f"{n}.bias"].detach().numpy(),
                                   np.asarray(want[n]["bias"]), rtol=1e-6, err_msg=n)
