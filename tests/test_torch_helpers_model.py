"""The JAX package's model helpers in the port, against JAX on the CPU:
`get_flops` and `model_info`, the NMS `Ensemble` through both predictors
with `attempt_load_weights`, `strip_optimizer` read back by JAX's npz
reader, `Profile`, `profile_layers`, the Chrome trace, and JAX's trainer
names.

* `get_flops` counts the products of convs, matrix products and the DCN
  (`mgdt::deform_fwd`'s formula, 2 B Ho Wo 9 Cin Cout). On a two-layer
  model it equals that count by hand, at stride 1 and 2, and the count is
  the same whether the DCN runs inside the operator or as the plain
  version outside it. JAX's XLA cost analysis counts the elementwise work
  and its DCN's sampling too: on the flagship at 128 px JAX counts 0.2513
  GFLOPs (its windowed `patch` path in training mode), the port 0.18577,
  0.739 of it (26.1% less); the test holds the ratio in [0.6, 1). Layers
  and parameters equal JAX's exactly.
* The ensemble (the committed flagship and a second flagship npz of
  randomised variables) at 64 px, both predictors at conf 0.01: the same
  detections per image, classes exact, boxes 1e-3 px, scores 1e-5 (the
  predictor's limits); the DCN runs once per member a forward.
* The stripped npz: float16 parameters; JAX's reader predicts within 2e-2
  of the float32 raw maps' magnitude (float16 rounds the weights to 2^-11
  of themselves).
"""
import copy
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from mgdt_yolo_tpu.nn.autobackend import load_npz_model
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.nn.tasks import Ensemble as JaxEnsemble
from mgdt_yolo_tpu.utils import torch_utils as jtu
from mgdt_yolo_tpu_torch.engine import trainer as T
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.engine.validator import BaseValidator, DetectionValidator
from mgdt_yolo_tpu_torch.nn.modules.block import DyDCNv2
from mgdt_yolo_tpu_torch.nn.tasks import (DetectionModel, Ensemble, attempt_load_one_weight,
                                          attempt_load_weights)
from mgdt_yolo_tpu_torch.ops import cuda_deform, deform
from mgdt_yolo_tpu_torch.utils import torch_utils as tu
from mgdt_yolo_tpu_torch.weights import export_variables, save_npz
from test_torch_model import _nest, _randomize
from test_torch_predict import _images
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "weights" / "mgdt_n_synth.npz"
ATOL_BOX, ATOL_SCORE = 1e-3, 1e-5


@pytest.fixture(scope="module")
def flagship():
    """(port flagship, JAX holder with the same committed variables)."""
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    with np.load(str(NPZ)) as f:
        jm.variables = _nest({k: f[k] for k in f.files})
    return DetectionModel.from_npz(NPZ, device="cpu"), jm


# ---------------------------------------------------------------------------
# get_flops and model_info
# ---------------------------------------------------------------------------

class TwoLayer(torch.nn.Module):
    """A 3x3 conv whose output splits into features and the DCN's offsets
    and mask, then a `DyDCNv2` at `stride`."""

    def __init__(self, stride=1):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 16 + 27, 3, padding=1)
        self.dcn = DyDCNv2(16, 16, stride=stride)
        self.stride = stride

    def forward(self, x):
        y = self.conv(x.permute(0, 3, 1, 2))
        f, om = y[:, :16], y[:, 16:]
        if self.stride > 1:
            om = om[:, :, ::self.stride, ::self.stride]
        return self.dcn(f, om[:, :18], om[:, 18:].sigmoid())


def _plain_dcn(x, offset, mask, weight, semantics="windowed", bias=None):
    """The DCN outside the operator: the plain version called directly."""
    dt = x.dtype
    return deform.modulated_deform_conv2d_plain(x, offset.to(dt), mask.to(dt), weight.to(dt),
                                                bias, semantics)


@pytest.mark.parametrize("stride", [1, 2])
def test_get_flops_is_the_count_by_hand_inside_and_outside_the_operator(stride, monkeypatch):
    s = 32
    m = TwoLayer(stride)
    ho = (s - 1) // stride + 1
    want = 2 * s * s * 9 * 3 * 43 + 2 * ho * ho * 9 * 16 * 16
    assert tu.get_flops(m, s) * 1e9 == want
    if stride == 1:
        monkeypatch.setattr(cuda_deform, "deform_conv", _plain_dcn)
        assert tu.get_flops(m, s) * 1e9 == want


def test_flagship_count_is_the_same_inside_and_outside_the_operator(flagship, monkeypatch):
    pm, _ = flagship
    inside = tu.get_flops(pm, 64)
    monkeypatch.setattr(cuda_deform, "deform_conv", _plain_dcn)
    assert tu.get_flops(pm, 64) == inside > 0


def test_model_info_matches_jax(flagship):
    pm, jm = flagship
    info = tu.model_info(pm, 128, verbose=False)
    assert info["layers"] == len(jm.specs) == 17
    assert info["params"] == jm.num_params()
    want = jtu.get_flops(jm, 128)
    ratio = info["gflops"] / want
    print(f"GFLOPs at 128 px: port {info['gflops']:.8g}, JAX {want:.8g}, ratio {ratio:.4f}")
    assert 0.6 < ratio < 1.0
    # the model itself is left in eval mode with its statistics
    assert not pm.training


def test_profile_layers_profile_and_trace(flagship, tmp_path):
    pm, _ = flagship
    deltas = tu.profile_layers(pm, imgsz=64, runs=1)
    assert len(deltas) == len(pm.specs) and all(np.isfinite(deltas))
    with tu.Profile("cpu") as p:
        pm(torch.zeros(1, 32, 32, 3))
    assert p.dt > 0 and p.t == p.dt and p.device is None
    log_dir = tu.start_trace(tmp_path / "trace")
    with pytest.raises(RuntimeError):
        tu.start_trace(tmp_path)
    with torch.no_grad():
        pm(torch.zeros(1, 32, 32, 3))
    path = Path(tu.stop_trace())
    assert path.parent == Path(log_dir) and "mgdt::deform_fwd" in path.read_text()
    with pytest.raises(RuntimeError):
        tu.stop_trace()


def test_init_seeds_one_cycle():
    import random
    jtu.init_seeds(7)
    want = (random.random(), np.random.rand(3))
    g = tu.init_seeds(7)
    assert (random.random(), *np.random.rand(3)) == (want[0], *want[1])
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=tu.init_seeds(7)))
    f, jf = tu.one_cycle(0.1, 1.0, 50), jtu.one_cycle(0.1, 1.0, 50)
    assert [f(i) for i in range(0, 60, 7)] == [jf(i) for i in range(0, 60, 7)]


# ---------------------------------------------------------------------------
# the ensemble
# ---------------------------------------------------------------------------

def _second_member(tmp_path, jm):
    """A second flagship checkpoint of randomised variables, written by the
    port (npz and metadata); the JAX holder of the same variables."""
    flat = _randomize(jm.variables, seed=9)
    pm = DetectionModel(device="cpu")
    from mgdt_yolo_tpu_torch.weights import load_jax_variables, load_state
    load_state(pm, load_jax_variables(flat))
    path = save_npz(pm, tmp_path / "second.npz",
                    {"model_yaml": pm.model_yaml, "nc": pm.nc, "deform_semantics": "windowed"})
    jm2 = copy.copy(jm)
    jm2.variables = _nest(flat)
    return path, jm2


def test_ensemble_through_both_predictors_matches_jax(flagship, tmp_path, monkeypatch):
    _, jm = flagship
    second, jm2 = _second_member(tmp_path, jm)
    ens = attempt_load_weights([NPZ, second], device="cpu")
    assert isinstance(ens, Ensemble) and len(ens) == 2 and ens.deform_semantics == "windowed"
    jens = JaxEnsemble([jm, jm2])
    assert tuple(ens.stride) == tuple(jens.stride) and ens.nc == jens.nc == 2
    imgs = _images([(64, 64), (128, 96), (64, 48)], seed=21)
    kw = {"imgsz": 64, "conf": 0.01}
    calls = []
    real = cuda_deform.deform_fwd
    monkeypatch.setattr(cuda_deform, "deform_fwd", lambda *a, **k: calls.append(1) or real(*a, **k))
    ours = DetectionPredictor(overrides={**kw, "device": "cpu"}).setup_model(ens)
    got = ours(imgs, batch=3)
    assert len(calls) == 2  # one batch, each member's DCN once
    theirs = JaxPredictor(overrides={**kw, "save": False})
    theirs.setup_model(jens)
    want = theirs(imgs, batch=3)
    n = 0
    for g, w in zip(got, want):
        a, b = g.boxes.data, np.asarray(w.boxes.data)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 5], b[:, 5])
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=ATOL_BOX)
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=ATOL_SCORE)
        n += len(a)
    assert n > 0
    # the detections are NMS over the members' decoded outputs, concatenated
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        cat, none = ens(x)
        parts = [m(x)[0] for m in ens.members]
    assert none is None and torch.equal(cat, torch.cat(parts, dim=-1))


def test_ensemble_forwards_fuse_and_pins_and_refuses_class_counts(tmp_path):
    a = attempt_load_one_weight(NPZ, device="cpu")
    b = attempt_load_one_weight("yolov8n.yaml", device="cpu", fuse=True)
    assert isinstance(b, DetectionModel) and b.n_fused > 0
    ens = Ensemble([a, DetectionModel("yolov8n.yaml", nc=2, device="cpu")])
    assert tuple(ens.stride) == (8.0, 16.0, 32.0)  # the member of the largest stride
    ens.set_deform_semantics("exact")
    assert all(m.deform_semantics == "exact" for m in ens.members)
    ens.fuse()
    assert all(getattr(m, "n_fused", 0) > 0 for m in ens.members)
    with pytest.raises(ValueError, match="class counts"):
        Ensemble([a, b])  # 2 classes against yolov8n's 80
    with pytest.raises(AssertionError, match="class counts"):
        JaxEnsemble([SimpleNamespace(nc=2), SimpleNamespace(nc=80)])
    assert attempt_load_weights(NPZ, device="cpu").nc == 2


def test_validator_takes_an_ensemble(flagship):
    """The validator runs an ensemble as a model (the synthetic val split at
    64 px, one batch) and gives finite metrics; `BaseValidator` holds its
    arguments and default loader."""
    from mgdt_yolo_tpu_torch.data.build import DataLoader
    from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
    pm, _ = flagship
    ens = Ensemble([pm, copy.deepcopy(pm)])
    loader = DataLoader(SyntheticDetectionDataset(n=4, imgsz=64, nc=2), 4, 64, train=False)
    v = DetectionValidator({"imgsz": 64, "batch": 4, "plots": False}, dataloader=loader)
    assert isinstance(v, BaseValidator) and v.dataloader is loader and v.args["half"] is False
    res = v(ens)
    assert np.isfinite(res["fitness"])


# ---------------------------------------------------------------------------
# strip_optimizer
# ---------------------------------------------------------------------------

def test_strip_optimizer_is_read_by_jax(tmp_path):
    pm = DetectionModel("yolov8n.yaml", nc=2, device="cpu")
    last = save_npz(pm, tmp_path / "weights" / "last.npz",
                    {"model_yaml": pm.model_yaml, "nc": 2, "deform_semantics": "windowed",
                     "epoch": 3})
    np.savez(tmp_path / "weights" / "last_resume.npz", step=np.array(9))
    out = Path(tu.strip_optimizer(last))
    assert out == tmp_path / "weights" / "last_stripped.npz"
    meta = json.loads((out.parent / "last_stripped_metadata.json").read_text())
    assert meta["stripped"] is True and meta["deform_semantics"] == "windowed" and \
        meta["epoch"] == 3
    ref = export_variables(pm)
    with np.load(out) as f:
        assert set(f.files) == set(ref) and "step" not in f.files
        for k in f.files:
            assert f[k].dtype == (np.float16 if k.startswith("params.") else np.float32), k
    jm, jmeta = load_npz_model(out)
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(lambda v, x: jm.model.apply(v, x, train=False)[1])(
        jm.variables, jnp.asarray(x))]
    with torch.no_grad():
        got = [a.numpy() for a in pm(torch.from_numpy(x))[1]]
    for g, w in zip(got, want):
        scale = float(np.abs(g).max())
        assert np.abs(g - w).max() <= 2e-2 * scale
    assert Path(tu.strip_optimizer(last, tmp_path / "x.npz")).is_file()


# ---------------------------------------------------------------------------
# JAX's trainer names
# ---------------------------------------------------------------------------

def test_trainer_names_fix_their_task():
    det = DetectionModel("yolov8n.yaml", nc=2, device="cpu")
    seg = DetectionModel("yolov8n-seg.yaml", nc=2, device="cpu")
    over = {"imgsz": 64, "batch": 4, "plots": False}
    for cls in (T.BaseTrainer, T.DetectionTrainer):
        assert cls(det, overrides=over).task == "detect"
        with pytest.raises(ValueError, match="segment"):
            cls(seg, overrides=over)
    assert T.SegmentationTrainer(seg, overrides=over).task == "segment"
    with pytest.raises(ValueError, match="detect"):
        T.SegmentationTrainer(det, overrides=over)
    with pytest.raises(ValueError, match="PoseTrainer trains pose"):
        T.PoseTrainer(det, overrides=over)
    assert issubclass(T.PoseTrainer, T.DetectionTrainer) and issubclass(T.BaseTrainer, T.Trainer)
