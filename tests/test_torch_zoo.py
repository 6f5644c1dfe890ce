"""The rest of the JAX package's model zoo in the port against JAX on the
CPU: YOLOv3 (plain, SPP, tiny), YOLOv5 (P5, P6), YOLOv6, YOLOv8 on P2-P5 and
P3-P6, and YOLOv8-pose on P3-P6.

Each config's literal equals its YAML (`tests/test_torch_ablation.py::
test_config_literal_matches_yaml`, over all of `models.CONFIGS`); the layer
specs, channel list, strides (those of JAX's `tests/test_model_zoo.py`),
flax variable names and parameter count equal JAX's, the v3s' at their
only width without a forward. The forwards hold JAX's through `weights.load_jax_variables` from
JAX's seeded variables with randomised norm statistics, scales and biases,
at 64 px (the v3s on a copy of their config at `width_multiple` 0.25, which
both sides take). Pinned apart: v5's padded stem, v6's ReLU and bare
transposed conv (an asymmetric kernel), v3-tiny's ZeroPad and MaxPool,
and a repeated row's flax names. A P6 `Detect` and the pose-P6 model take
JAX's float64 SGD step (loss, parts, gradient norm, parameters, EMA and
statistics) at 192 px, at the limits the ablation models' and the pose
model's steps are held to; npz goes both ways and a
reference `.pt` reads as JAX reads it. The serving and training entry
points take the 4-level heads (stride 4 or 64) unchanged. Tolerances, each
with its reason:

* the eval forward, float32: the decoded output and every raw map to 1e-4
  of its magnitude (at least 1), as the ablation models' (`RTOL_RAW`);
* the single modules: exact where the port computes what JAX computes
  (pads, pools, the transposed conv's taps), else 1e-6 of the magnitude;
* the step: as `tests/test_torch_seg_pose.py` (float64: loss and parts
  1e-6 relative, the gradient norm 1e-5, each parameter's and EMA's change
  1e-5 of its largest plus 1e-6 of the largest change of all, statistics
  1e-6). At 128 px the P6 level is 2 x 2, so its BatchNorm normalises 12
  values a channel in a batch of 3, and the pose-P6 step's change of
  `model_2.cv1.norm.bn.bias` strayed 2.6e-7 from JAX's against a 1.75e-7
  limit (the float32 loss's rounding, amplified); at 192 px (27 values)
  both steps hold it;
* the predictor: the classes exactly, boxes 1e-3 px, scores 1e-5, as
  `tests/test_torch_predict.py` holds the flagship's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.trainer import TrainState, make_train_step
from mgdt_yolo_tpu.nn.modules import conv as JC
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils.loss import DetectionLoss as JaxDetectionLoss
from mgdt_yolo_tpu.utils.loss_seg_pose import PoseLoss as JaxPoseLoss
from mgdt_yolo_tpu.utils.torch_import import load_torch_pt as jax_load_torch_pt
from mgdt_yolo_tpu.utils.torch_import import load_torch_state_dict as jax_load_state_dict
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.engine.serve import InferenceServer
from mgdt_yolo_tpu_torch.engine.trainer import Trainer, build_loader
from mgdt_yolo_tpu_torch.models import load_config
from mgdt_yolo_tpu_torch.nn.autobackend import AutoBackend
from mgdt_yolo_tpu_torch.nn.modules.conv import Conv, ConvTranspose, MaxPool2d, ZeroPad2d
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel, parse_model
from mgdt_yolo_tpu_torch.tools.reference_pt import write_reference_pt
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, flax_keys,
                                         load_jax_variables, load_state, save_npz)
from test_torch_ablation import RTOL_RAW
from test_torch_ablation_train import OVERRIDES, _close, _flax, _jax_optimizer
from test_torch_model import _randomize
from test_torch_train import _nest
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

# JAX's `tests/test_model_zoo.py` list, and the pose-P6 model
ZOO_STRIDES = {
    "yolov8n-p2.yaml": (4, 8, 16, 32),
    "yolov8n-p6.yaml": (8, 16, 32, 64),
    "yolov5n.yaml": (8, 16, 32),
    "yolov5n-p6.yaml": (8, 16, 32, 64),
    "yolov3-tiny.yaml": (16, 32),
    "yolov3.yaml": (8, 16, 32),
    "yolov3-spp.yaml": (8, 16, 32),
    "yolov6n.yaml": (8, 16, 32),
    "yolov8n-pose-p6.yaml": (8, 16, 32, 64),
}
WIDE = ("yolov3.yaml", "yolov3-spp.yaml")  # ~100M parameters at their only width
IMGSZ = 64


def _config(name):
    """The config a forward test builds: by file name, the v3s as a copy
    of their dict at width 0.25."""
    if name not in WIDE:
        return name
    d = load_config(name)
    d.update(width_multiple=0.25, yaml_file=None)
    return d


def _norm(a):
    """A spec argument with lists as tuples (JAX freezes them)."""
    return tuple(_norm(x) for x in a) if isinstance(a, (list, tuple)) else a


@pytest.mark.parametrize("name", sorted(ZOO_STRIDES))
def test_structure_matches_jax(name):
    """The specs (index, inputs, type, arguments, repeats, width), the
    strides without a probe run, the flax names and the parameter count,
    all as JAX's; the file name resolves its scale as JAX's
    `yaml_model_load` does."""
    jm = JaxDetectionModel(name)
    pm = DetectionModel(name, device="cpu")
    assert pm.stride == jm.stride == ZOO_STRIDES[name]
    assert len(pm.specs) == len(jm.specs)
    for p, j in zip(pm.specs, jm.specs):
        assert (p.i, p.f, p.name, p.n, p.c2) == (j.i, j.f, j.name, j.n, j.c2), p
        assert _norm(p.args) == _norm(j.args), p
    assert set(flax_keys(pm).values()) == set(flatten_variables(jax.device_get(jm.variables)))
    assert sum(p.numel() for p in pm.parameters()) == jm.num_params()
    assert (pm.task, pm.model_yaml) == ("pose" if "pose" in name else "detect", name)
    d = load_config(name)
    assert d["scale"] == ("" if name.startswith("yolov3") else "n") and d["yaml_file"] == name


@pytest.mark.parametrize("name", sorted(ZOO_STRIDES))
def test_forward_matches_jax(name):
    """The eval forward, decoded output and raw maps (and the pose head's
    raw keypoints), against JAX's after the carry at 64 px."""
    cfg = _config(name)
    jm = JaxDetectionModel(copy.deepcopy(cfg) if isinstance(cfg, dict) else cfg)
    start = _randomize(jm.variables, seed=3)
    pm = DetectionModel(cfg, device="cpu")
    load_state(pm, load_jax_variables(start))
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.model.apply(v, x, train=False))(_nest(start),
                                                                   jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    n_anchor = sum((IMGSZ // s) ** 2 for s in ZOO_STRIDES[name])
    assert got[0].shape == (2, 4 + pm.nc + (51 if "pose" in name else 0), n_anchor)
    g_leaves = [got[0], *jax.tree.leaves([list(t) if isinstance(t, list) else t
                                          for t in got[1]])]
    w_leaves = [want[0], *jax.tree.leaves(want[1])]
    assert len(g_leaves) == len(w_leaves) == 1 + len(pm.stride) + ("pose" in name)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, 0.0, f"{name} {w.shape}",
               atol=RTOL_RAW * max(1.0, float(np.abs(w).max())))


def test_padded_stem_and_grouped_conv_match_jax():
    """v5's stem `Conv [64, 6, 2, 2]` (kernel 6, stride 2, pad 2) on an odd
    map, and a Conv with its groups, dilation and own activation, against
    JAX's `Conv` at those arguments."""
    assert DetectionModel("yolov5n.yaml", device="cpu").model_0.conv.padding == (2, 2)
    rng = np.random.default_rng(0)
    for (c1, c2, k, s, p, g, d, act), hw in (((3, 16, 6, 2, 2, 1, 1, True), (13, 17)),
                                             ((8, 12, 3, 1, None, 4, 2, "relu"), (9, 11))):
        x = rng.standard_normal((2, *hw, c1)).astype(np.float32)
        jm = JC.Conv(c2, k, s, p=p, g=g, d=d, act=act)
        flat = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
        want = np.asarray(jm.apply(_nest(flat), jnp.asarray(x)))
        pc = Conv(c1, c2, k, s, p, g, d, act)
        load_state(pc, load_jax_variables(flat))
        with torch.no_grad():
            got = pc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.shape == want.shape
        _close(got.numpy(), want, 1e-6, f"Conv k{k} s{s} p{p} g{g} d{d}")


def test_v6_relu_reaches_every_default_conv_of_its_model_only():
    """The config's `activation: nn.ReLU()` replaces SiLU in every Conv
    built with `act=True`, the Detect head's too, as JAX's trace-time
    default does; a model built after it keeps SiLU (JAX's default is
    process-wide for a trace, the port's per model)."""
    v6 = DetectionModel("yolov6n.yaml", device="cpu")
    convs = [m for m in v6.modules() if isinstance(m, Conv)]
    assert convs and all(isinstance(m.act, torch.nn.ReLU) for m in convs)
    assert isinstance(getattr(v6, f"model_{v6.specs[-1].i}").cv2_0_0.act, torch.nn.ReLU)
    v8 = DetectionModel("yolov8n.yaml", device="cpu")
    assert all(isinstance(m.act, torch.nn.SiLU) for m in v8.modules() if isinstance(m, Conv))


def test_bare_transposed_conv_maps_flax_taps():
    """v6's `nn.ConvTranspose2d [c2, 2, 2, 0]` is JAX's `ConvTranspose(bn=False,
    act=False)`: an asymmetric kernel (distinct taps, in != out channels,
    a rectangular input) gives JAX's output after the carry, the flax
    kernel comes back, and torch's weight[:, :, a, b] is flax's kernel[1 - a,
    1 - b]."""
    c1, c2 = 4, 6
    x = np.random.default_rng(0).standard_normal((2, 5, 7, c1)).astype(np.float32)
    jm = JC.ConvTranspose(c2, 2, 2, 0, bn=False, act=False)
    flat = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=2)
    rng = np.random.default_rng(1)
    flat["params.conv_transpose.kernel"] = (np.arange(4 * c1 * c2).reshape(2, 2, c1, c2) / 100.0
                                            + rng.uniform(0, 1e-3, (2, 2, c1, c2))
                                            ).astype(np.float32)
    want = np.asarray(jm.apply(_nest(flat), jnp.asarray(x)))
    pm = ConvTranspose(c1, c2, 2, 2, 0)
    load_state(pm, load_jax_variables(flat))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 14, c2)
    _close(got, want, 1e-6, "ConvTranspose")
    np.testing.assert_array_equal(export_variables(pm)["params.conv_transpose.kernel"],
                                  flat["params.conv_transpose.kernel"])
    np.testing.assert_array_equal(pm.conv_transpose.weight.detach().numpy()[:, :, 0, 1],
                                  flat["params.conv_transpose.kernel"][1, 0])
    assert parse_model(load_config("yolov6n.yaml"))[0][11].stride == 16  # 32 // 2


def test_zero_pad_and_max_pool_match_jax():
    """v3-tiny's `nn.ZeroPad2d [[0, 1, 0, 1]]` then `nn.MaxPool2d [2, 1, 0]`
    (the size kept), and `[2, 2, 0]` on an odd map (the last row and
    column dropped), exactly as JAX's, on negative values where a pad
    must not win."""
    x = np.random.default_rng(0).standard_normal((2, 7, 9, 3)).astype(np.float32) - 3.0
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    pad = JC.ZeroPad2d((0, 1, 0, 1))
    want = np.asarray(pad.apply({}, jnp.asarray(x)))
    got = ZeroPad2d([0, 1, 0, 1])(xt)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    for (k, s, p), inp, ref in (((2, 1, 0), got, want), ((2, 2, 0), xt, x),
                                ((3, 2, 1), xt, x)):
        w = np.asarray(JC.MaxPool2d(k, s, p).apply({}, jnp.asarray(ref)))
        g = MaxPool2d(k, s, p)(inp).permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    specs = parse_model(load_config("yolov3-tiny.yaml"))[0]
    assert [s.stride for s in specs[7:13]] == [16, 16, 32, 32, 32, 32]


def test_repeated_rows_map_onto_a_sequential():
    """A non-CSP row with n > 1 (v3's `Bottleneck` x 8, v6's `Conv` x 6) is
    an `nn.Sequential` of n modules: JAX's `model_i` is its child 0 and
    `model_i_repR` its child R, both ways; the copies after the first take
    the row's output width."""
    pm = DetectionModel(_config("yolov3.yaml"), device="cpu")
    seq = pm.model_6
    assert isinstance(seq, torch.nn.Sequential) and len(seq) == 8 and pm.specs[6].n == 8
    assert pm.specs[2].n == 1 and not isinstance(pm.model_2, torch.nn.Sequential)
    keys = flax_keys(pm)
    assert keys["model_6.0.cv1.conv.weight"] == "params.model_6.cv1.conv.kernel"
    assert keys["model_6.7.cv2.norm.bn.running_var"] == "batch_stats.model_6_rep7.cv2.norm.bn.var"
    state = load_jax_variables(export_variables(pm))
    assert set(state) == {k for k in pm.state_dict() if not k.endswith("num_batches_tracked")}
    v6 = DetectionModel("yolov6n.yaml", device="cpu")
    assert [m.conv.in_channels for m in v6.model_2] == [32, 32]


STEP_IMGSZ = 192  # P6 at 3 x 3: BatchNorm over 27 values a channel


def _train_batch(task):
    ds = SyntheticDetectionDataset(n=3, imgsz=STEP_IMGSZ, nc=2 if task == "detect" else 1,
                                   seed=4, task=task)
    items = [ds[i] for i in range(3)]
    return collate(items, STEP_IMGSZ, DataLoader(ds, 3, STEP_IMGSZ).max_gt)


_STEP_CFG = {"detect": "yolov8-p6.yaml", "pose": "yolov8-pose-p6.yaml"}
_RUNS = {}


def _step_config(task):
    """The P6 config of the task at width 0.125, nc 2 (pose: 1)."""
    d = load_config(_STEP_CFG[task])
    d.update(scales={"n": [0.33, 0.125, 1024]}, scale="n", nc=2 if task == "detect" else 1)
    return d


def _step_run(task):
    """JAX's float64 train state and metrics after an SGD step from
    randomised float32 variables (flat)."""
    if task in _RUNS:
        return _RUNS[task]
    jm = JaxDetectionModel(_step_config(task))
    start = _randomize(jm.variables, seed=3)
    batch = _train_batch(task)
    with jax.enable_x64(True):
        j64 = JaxDetectionModel(_step_config(task), dtype=jnp.float64)
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(start))
        crit = (JaxDetectionLoss(j64.nc, j64.reg_max, j64.stride) if task == "detect" else
                JaxPoseLoss(j64.nc, j64.reg_max, j64.stride, kpt_shape=(17, 3)))
        tx = _jax_optimizer(variables["params"])
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           ema_params=jax.tree.map(jnp.array, variables["params"]),
                           step=jnp.int32(0), ema_updates=jnp.int32(0))
        state, m = make_train_step(j64.model, crit, tx)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        run = {"start": start, "batch": batch, "metrics": jax.device_get(m),
               "state": jax.device_get(state)}
    _RUNS[task] = run
    return run


@pytest.mark.parametrize("task", ["detect", "pose"])
def test_p6_train_step_matches_jax_in_float64(task):
    """The 4-level head's loss (anchors on four grids, the assigner over
    them), its parts and gradient norm, and the SGD step's parameters, EMA
    and statistics, against JAX's in float64."""
    run = _step_run(task)
    pm = DetectionModel(_step_config(task), device="cpu")
    load_state(pm, load_jax_variables(run["start"]))
    pm = pm.double()
    assert pm.stride == (8, 16, 32, 64) and pm.task == task
    tr = Trainer(pm, overrides={**OVERRIDES, "batch": 3, "nbs": 3}, steps_per_epoch=1000)
    got, want = tr.train_step(to_device(run["batch"], "cpu")), run["metrics"]
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-6)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-5)
    state, start = run["state"], run["start"]
    params = flatten_variables(state.params, "params.")
    ema = flatten_variables(state.ema_params, "params.")
    stats = flatten_variables(state.batch_stats, "batch_stats.")
    floor = 1e-6 * max(np.abs(params[k] - start[k]).max() for k in params)
    keys, ours_ema = flax_keys(pm), tr.ema.state()
    for n, t in list(pm.named_parameters()) + list(pm.named_buffers()):
        if n not in keys:
            continue
        k = keys[n]
        got, base = _flax(k, t), start[k].astype(np.float64)
        if k in stats:
            _close(got, stats[k], 1e-6, f"batch statistic {n}")
            continue
        _close(got - base, params[k] - base, 1e-5, f"change of {n}", atol=floor)
        _close(_flax(k, ours_ema[n]) - base, ema[k] - base, 1e-5, f"EMA change of {n}",
               atol=floor + float(np.finfo(np.float32).eps) * np.abs(base).max())


@pytest.mark.parametrize("name", ["yolov6n.yaml", "yolov5n-p6.yaml"])
def test_npz_both_ways_and_reference_pt_read_as_jax(name, tmp_path):
    """JAX's variables through the port and back (repeats and the bare
    deconv included) exactly; a port npz reloads, and `AutoBackend` over it
    gives the live forward, bit for bit; a reference `.pt` written from the port reads through
    JAX's import and the port's to the same values, bit for bit."""
    jm = JaxDetectionModel(name, nc=3)
    start = _randomize(jm.variables, seed=5)
    pm = DetectionModel(name, nc=3, device="cpu")
    load_state(pm, load_jax_variables(start))
    back = export_variables(pm)
    assert set(back) == set(start)
    for k in start:
        np.testing.assert_array_equal(back[k], start[k], err_msg=k)
    path = save_npz(pm, tmp_path / "w.npz", {"model_yaml": name, "nc": 3})
    re = DetectionModel.from_npz(path, device="cpu")
    for (n, a), (_, b) in zip(pm.state_dict().items(), re.state_dict().items()):
        assert torch.equal(a, b), n
    x = np.random.default_rng(1).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with torch.no_grad():
        live = pm(torch.from_numpy(x))[0]
    torch.testing.assert_close(AutoBackend(path, imgsz=IMGSZ, device="cpu").forward(x), live,
                               rtol=0, atol=0)
    pt = write_reference_pt(pm, tmp_path / "ref.pt")
    sd, train_args = jax_load_torch_pt(pt)
    want, rep = jax_load_state_dict(jm.variables, sd, verbose=False)
    ours, _ = DetectionModel.from_pt(pt, device="cpu")
    assert rep["name_missed"] == rep["shape_missed"] == [] and train_args["model"] == name
    assert ours.import_report["matched"] == rep["matched"]
    got = export_variables(ours)
    for k, v in flatten_variables(jax.device_get(want)).items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


def _p6_models():
    d = load_config("yolov8n-p6.yaml")
    d.update(scales={"n": [0.33, 0.125, 1024]}, nc=2)
    return d


def test_predictor_and_server_take_a_stride_64_level():
    """The predictor letterboxes to the square imgsz (a multiple of 64) as
    JAX's does; its model's decoded output on that batch is JAX's, and its
    results are JAX's NMS and rescaling of that output (a seeded model's
    scores barely depend on the image and sit near ties, so the last bits
    of a forward could reorder a whole NMS; the NMS is held on one tensor);
    the server's results are the predictor's at the same batch, bit for
    bit."""
    from mgdt_yolo_tpu.engine.predictor import det_to_original as jax_det_to_original
    from mgdt_yolo_tpu.engine.predictor import letterbox_batch as jax_letterbox_batch
    from mgdt_yolo_tpu.ops.nms import non_max_suppression as jax_nms
    from mgdt_yolo_tpu_torch.engine.predictor import letterbox_batch
    from test_torch_predict import _images
    jm = JaxDetectionModel(_p6_models())
    start = _randomize(jm.variables, seed=3)
    imgs = _images([(100, 150), (70, 40), (128, 128)], seed=2)
    x, meta = letterbox_batch(imgs, 128)
    jx, jmeta = jax_letterbox_batch(imgs, 128)
    np.testing.assert_array_equal(x, jx)
    assert x.shape == (3, 128, 128, 3) and meta == jmeta
    pm = DetectionModel(_p6_models(), device="cpu")
    load_state(pm, load_jax_variables(start))
    xf = x.astype(np.float32) / 255.0
    want = np.asarray(jax.jit(lambda v, x: jm.model.apply(v, x, train=False)[0])(
        _nest(start), jnp.asarray(xf)))
    ours = DetectionPredictor(overrides={"imgsz": 128, "conf": 0.001, "device": "cpu"})
    ours.setup_model(pm)
    with torch.no_grad():
        decoded = pm(torch.from_numpy(xf))[0].numpy()
    assert decoded.shape == (3, 6, 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2)
    _close(decoded, want, 0.0, "decoded", atol=RTOL_RAW * float(np.abs(want).max()))
    got = ours(imgs, batch=3)
    dets, counts = jax.device_get(jax.jit(lambda d: jax_nms(d, conf_thres=0.001, iou_thres=0.7,
                                                          max_det=300))(jnp.asarray(decoded)))
    assert sum(len(r) for r in got) == int(counts.sum()) > 0
    for j, r in enumerate(got):
        w = jax_det_to_original(np.asarray(dets[j][:int(counts[j])]).copy(), 128, jmeta[j])
        np.testing.assert_array_equal(r.boxes.data[:, 5], w[:, 5])
        np.testing.assert_allclose(r.boxes.data[:, :4], w[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(r.boxes.data[:, 4], w[:, 4], rtol=0, atol=1e-5)
    with InferenceServer(pm, batch=3, max_wait_ms=200.0, imgsz=128, conf=0.001,
                         device="cpu") as server:
        futs = [server.submit(im) for im in imgs]
        served = [f.result(timeout=120) for f in futs]
    for g, s in zip(got, served):
        np.testing.assert_array_equal(g.boxes.data, s.boxes.data)


@pytest.mark.parametrize("name,device_augment", [("yolov8n-p6.yaml", True),
                                                 ("yolov8n-p2.yaml", False),
                                                 ("yolov8n-pose-p6.yaml", False)])
def test_trainer_takes_4_level_heads(name, device_augment):
    """One epoch through `Trainer.train` (the device and the host pipeline)
    with validation on a P6 / P2 detect and the pose-P6 model: finite
    losses, the assigner over 4 grids of anchors."""
    d = load_config(name)
    d.update(scales={"n": [0.33, 0.125, 1024]})
    pm = DetectionModel(d, nc=1 if "pose" in name else 2, device="cpu")
    tr = Trainer(pm, overrides={"imgsz": 64, "batch": 4, "epochs": 1, "plots": False,
                                "device_augment": device_augment, "workers": 2})
    assert tr.device_augment == device_augment and len(tr.criterion.strides) == 4
    metrics = tr.train()
    assert np.isfinite([m["loss"].item() for m in tr.history]).all() and len(tr.history) == 16
    assert np.isfinite(metrics["fitness"])


def test_rect_validation_pads_to_the_largest_stride(tmp_path):
    """Rectangular validation batches of a P6 model are shaped to multiples
    of 64, its largest stride (JAX's `stride=max(model.stride)`), and run."""
    from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS
    from test_torch_dataset import write_dataset, write_yaml
    sizes = [(90, 200), (200, 90), (120, 120), (60, 250)]
    write_dataset(tmp_path, sizes[:2], "train")
    write_dataset(tmp_path, sizes, "val", seed=7)
    pm = DetectionModel(_p6_models(), device="cpu")
    loader = build_loader({**TRAIN_DEFAULTS, "data": str(write_yaml(tmp_path)), "imgsz": 128,
                           "batch": 2, "rect": True, "workers": 1}, False, pm)
    assert loader.rect and (np.asarray(loader.batch_shapes) % 64 == 0).all()
    assert {tuple(s) for s in loader.batch_shapes} != {(128, 128)}
    for batch in loader:
        assert batch["img"].shape[1] % 64 == 0 and batch["img"].shape[2] % 64 == 0
        with torch.no_grad():
            pm(torch.from_numpy(batch["img"]).float() / 255.0)
