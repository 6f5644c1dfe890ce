"""The segment and pose tasks of the port against the JAX package on the
CPU: `Proto`, the `Segment` and `Pose` heads, their losses and gradients,
two SGD steps of the trainer, the validators, the predictor, npz export
and reload, and reference `.pt` import.

The models are YOLOv8's `yolov8-seg.yaml` and `yolov8-pose.yaml` cut to
width 0.125 (depth 0.33, nc 2) and run at 64 px; both sides start from
JAX's seeded variables with randomised norm statistics, scales and biases,
carried across by `weights.load_jax_variables`. Batches are three synthetic
scenes of the task, collated by the port (`tests/test_torch_seg_pose_data.py`
holds that against JAX's collate): the second has no object, and in the pose
batch the third's keypoints are all invisible. Tolerances, each with its
reason:

* the eval forward, float32: the decoded output and every aux array to
  1e-4 of its magnitude (at least 1), as the ablation models' raw maps are
  held (`RTOL_RAW`, `tests/test_torch_ablation.py`); `Proto` alone to 1e-6
  of its magnitude; the training forward's values through its loss and
  gradients in float64, below;
* the losses, with JAX's in float64 (`jax.enable_x64`) and the port's model
  in float64: the total to 1e-6 relative, each part to 1e-6 of the largest,
  each parameter's gradient to 1e-5 of that tensor's largest gradient plus
  1e-6 of the largest of all (the loss is float32 on both sides, as in
  `tests/test_torch_ablation_train.py`);
* two float64 SGD steps: the first step's loss and parts to 1e-6 relative,
  the second's to 1e-5 (its parameters agree to the limits below, and the
  float32 mask loss carries that: 2.0e-6 seen); each parameter's and EMA's
  change to 1e-5
  of its largest change plus 1e-6 of the largest change of all (the EMA's
  plus one float32 spacing of its magnitude: its decay is float32 on both
  sides), batch statistics 1e-6;
* the validators: per image the same true-positive matrices (boxes and
  masks or keypoints), classes and label classes, confidences within 1e-5;
  the metric dicts within 1e-4 (a random model's confidences sit near the
  0.001 threshold, where a last-bit change of a score moves the precision
  curve's interpolation: up to 7.4e-6 seen);
* the predictor: the classes exactly, boxes 1e-3 px, scores 1e-5, as
  `tests/test_torch_predict.py` holds the flagship's.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.cfg import get_cfg as jax_get_cfg
from mgdt_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from mgdt_yolo_tpu.engine.trainer import TrainState, make_train_step
from mgdt_yolo_tpu.engine.validator_seg_pose import PoseValidator as JaxPoseValidator
from mgdt_yolo_tpu.engine.validator_seg_pose import \
    SegmentationValidator as JaxSegmentationValidator
from mgdt_yolo_tpu.engine.validator_seg_pose import _match_by_matrix as jax_match
from mgdt_yolo_tpu.engine.validator_seg_pose import kpt_oks_matrix as jax_oks
from mgdt_yolo_tpu.engine.validator_seg_pose import mask_iou_matrix as jax_mask_iou
from mgdt_yolo_tpu.nn.modules.block import Proto as JaxProto
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils import yaml_load
from mgdt_yolo_tpu.utils.loss_seg_pose import PoseLoss as JaxPoseLoss
from mgdt_yolo_tpu.utils.loss_seg_pose import SegmentationLoss as JaxSegmentationLoss
from mgdt_yolo_tpu.utils.torch_import import load_torch_pt as jax_load_torch_pt
from mgdt_yolo_tpu.utils.torch_import import load_torch_state_dict as jax_load_state_dict
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset, synthetic_scene
from mgdt_yolo_tpu_torch.engine.model import YOLO
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.engine.trainer import Trainer
from mgdt_yolo_tpu_torch.engine.validator_seg_pose import (PoseValidator,
                                                           SegmentationValidator,
                                                           _match_by_matrix, kpt_oks_matrix,
                                                           mask_iou_matrix)
from mgdt_yolo_tpu_torch.nn.autobackend import AutoBackend
from mgdt_yolo_tpu_torch.nn.modules.block import Proto
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel, PoseModel, SegmentationModel
from mgdt_yolo_tpu_torch.tools.reference_pt import write_reference_pt
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, flax_keys,
                                         load_jax_variables, load_state)
from test_torch_ablation import RTOL_RAW
from test_torch_ablation_train import OVERRIDES, _close, _flax, _jax_optimizer
from test_torch_model import _randomize
from test_torch_predict import _same_results
from test_torch_train import _nest
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

YAMLS = Path(__file__).resolve().parents[1] / "mgdt_yolo_tpu" / "models" / "v8"
IMGSZ = 64
TASKS = {"segment": "yolov8-seg.yaml", "pose": "yolov8-pose.yaml"}
STEP_OVERRIDES = {**OVERRIDES, "batch": 3, "nbs": 3}


def _config(task):
    """The task's YOLOv8 config at width 0.125, nc 2, as the JAX YAML."""
    d = yaml_load(YAMLS / TASKS[task])
    d.update(scales={"n": [0.33, 0.125, 1024]}, scale="n", nc=2)
    return d


def _batch(task):
    """Three scenes of the task at IMGSZ, collated: the second without
    objects; for pose, the third with every keypoint invisible."""
    ds = SyntheticDetectionDataset(n=3, imgsz=IMGSZ, seed=4, task=task)
    items = [ds[i] for i in range(3)]
    key = "masks" if task == "segment" else "keypoints"
    items[1] = {**items[1], "boxes": np.zeros((0, 4), np.float32),
                "cls": np.zeros((0,), np.float32),
                key: items[1][key][:0]}
    if task == "pose":
        k = items[2]["keypoints"].copy()
        k[..., 2] = 0.0
        items[2] = {**items[2], "keypoints": k}
    return collate(items, IMGSZ, 8)


_RUNS = {}


def _run(task):
    """JAX's float32 model of the task with its randomised start (flat), a
    batch, and, in float64: the loss, parts and gradients there and the
    train state after two SGD steps. Built once per task."""
    if task in _RUNS:
        return _RUNS[task]
    jm = JaxDetectionModel(_config(task))
    start = _randomize(jm.variables, seed=3)
    batch = _batch(task)
    run = {"jm": jm, "start": start, "batch": batch}
    with jax.enable_x64(True):
        j64 = JaxDetectionModel(_config(task), dtype=jnp.float64)
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(start))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if task == "segment":
            crit = JaxSegmentationLoss(j64.nc, j64.reg_max, j64.stride)
        else:
            crit = JaxPoseLoss(j64.nc, j64.reg_max, j64.stride, kpt_shape=(17, 3))

        def loss_fn(params, batch_stats, img, targets):
            out, _ = j64.model.apply({"params": params, "batch_stats": batch_stats},
                                     img, train=True, mutable=["batch_stats"])
            lo = crit(out[1], targets, 0)
            return lo.total, lo.parts
        targets = {k: v for k, v in jb.items() if k != "img"}
        (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"],
            jb["img"].astype(jnp.float64) / 255.0, targets)
        run.update(loss=float(loss), parts=np.asarray(parts),
                   grads=flatten_variables(jax.device_get(grads), "params."))
        tx = _jax_optimizer(variables["params"])
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           ema_params=jax.tree.map(jnp.array, variables["params"]),
                           step=jnp.int32(0), ema_updates=jnp.int32(0))
        step_fn = make_train_step(j64.model, crit, tx)
        run["metrics"] = []
        for _ in range(2):
            state, m = step_fn(state, jb)
            run["metrics"].append(jax.device_get(m))
        run["state"] = jax.device_get(state)
    _RUNS[task] = run
    return run


def _flax64(key, t):
    """A port tensor in flax's layout for `key`, in float64 (`Proto`'s
    transposed conv too)."""
    if key.endswith(".upsample.kernel"):
        return t.detach().double().numpy().transpose(2, 3, 0, 1)[::-1, ::-1]
    return _flax(key, t)


def _port(task, run, dtype=torch.float32):
    pm = DetectionModel(_config(task), device="cpu")
    load_state(pm, load_jax_variables(run["start"]))
    return pm.to(dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_proto_transposed_conv_maps_flax_taps():
    """flax's `ConvTranspose` kernel is torch's with both spatial axes
    flipped: an asymmetric 2x2 kernel (distinct taps, a rectangular
    input, in != out channels) gives JAX's output exactly after the carry,
    and `to_flax_layout` gives the flax kernel back."""
    c1, c_, c2 = 4, 6, 3
    jp = JaxProto(c_, c2)
    x = np.random.default_rng(0).standard_normal((2, 5, 7, c1)).astype(np.float32)
    variables = jax.device_get(jp.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = _randomize(variables, seed=2)
    rng = np.random.default_rng(1)
    flat["params.upsample.kernel"] = (np.arange(4 * c_ * c_).reshape(2, 2, c_, c_) / 100.0
                                      + rng.uniform(0, 1e-3, (2, 2, c_, c_))).astype(np.float32)
    want = np.asarray(jp.apply(_nest(flat), jnp.asarray(x)))
    pp = Proto(c1, c_, c2)
    load_state(pp, load_jax_variables(flat))
    pp.eval()
    with torch.no_grad():
        got = pp(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 14, c2)
    _close(got, want, 1e-6, "Proto")
    back = export_variables(pp)
    np.testing.assert_array_equal(back["params.upsample.kernel"], flat["params.upsample.kernel"])
    # the taps: torch's weight[:, :, a, b] is flax's kernel[1 - a, 1 - b]
    np.testing.assert_array_equal(pp.upsample.weight.detach().numpy()[:, :, 0, 1],
                                  flat["params.upsample.kernel"][1, 0])


@pytest.mark.parametrize("task", sorted(TASKS))
def test_heads_match_jax(task):
    """The eval forward's decoded output and every aux array (raw maps, the
    coefficients and prototypes, or the raw keypoints), and the training
    forward's aux structure and shapes, against JAX's after the carry; the
    flax keys round-trip."""
    run = _run(task)
    pm = _port(task, run)
    assert pm.task == task and type(pm.model_22).__name__ == ("Segment" if task == "segment"
                                                              else "Pose")
    back = export_variables(pm)
    assert set(back) == set(run["start"])
    x = np.random.default_rng(2).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    jm = run["jm"]
    for train in (False, True):
        want = jax.jit(lambda v, x: jm.model.apply(v, x, train=train,
                                                   mutable=["batch_stats"] if train else False)
                       )(_nest(run["start"]), jnp.asarray(x))
        want = want[0] if train else want
        pm.train(train)
        with torch.no_grad():
            got = pm(torch.from_numpy(x))
        if not train:
            nk = 4 + 2 + (32 if task == "segment" else 51)
            assert got[0].shape == (2, nk, 84)
            _close(got[0].numpy(), np.asarray(want[0]), 0.0, "decoded",
                   atol=RTOL_RAW * max(1.0, float(np.abs(want[0]).max())))
        else:
            assert got[0] is None and want[0] is None
        g_leaves = [t for part in got[1] for t in (part if isinstance(part, list) else [part])]
        w_leaves = jax.tree.leaves(want[1])
        assert len(g_leaves) == len(w_leaves) == (5 if task == "segment" else 4)
        for g, w in zip(g_leaves, w_leaves):
            assert tuple(g.shape) == tuple(w.shape)
            if not train:  # training's values: in float64, through the loss test
                _close(g.numpy(), np.asarray(w), 0.0, f"aux {tuple(g.shape)}",
                       atol=RTOL_RAW * max(1.0, float(np.abs(w).max())))


# ---------------------------------------------------------------------------
# losses and training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", sorted(TASKS))
def test_loss_and_gradients_match_jax_in_float64(task):
    run = _run(task)
    pm = _port(task, run, torch.float64).train()
    tr = Trainer(pm, overrides=STEP_OVERRIDES, steps_per_epoch=1000)
    assert type(tr.criterion).__name__ == ("SegmentationLoss" if task == "segment"
                                           else "PoseLoss")
    batch = to_device(run["batch"], "cpu")
    assert not batch["mask_gt"][1].any()
    out = tr.criterion(pm.forward_feats(batch["img"].double() / 255.0), batch, 0)
    out.total.backward()
    assert out.parts.shape == ((4,) if task == "segment" else (5,))
    np.testing.assert_allclose(out.total.item(), run["loss"], rtol=1e-6)
    np.testing.assert_allclose(out.parts.numpy(), run["parts"], rtol=0,
                               atol=1e-6 * run["parts"].max())
    assert (run["parts"] > 0).all()
    keys = flax_keys(pm)
    floor = 1e-6 * max(np.abs(g).max() for g in run["grads"].values())
    for n, p in pm.named_parameters():
        want = run["grads"][keys[n]]
        _close(_flax64(keys[n], p.grad), want, 1e-5, f"gradient of {n}", atol=floor)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_two_sgd_steps_match_jax(task):
    run = _run(task)
    pm = _port(task, run, torch.float64)
    tr = Trainer(pm, overrides=STEP_OVERRIDES, steps_per_epoch=1000)
    batch = to_device(run["batch"], "cpu")
    metrics = [tr.train_step(batch) for _ in range(2)]
    for i, (got, want) in enumerate(zip(metrics, run["metrics"])):
        rtol = 1e-6 if i == 0 else 1e-5
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=rtol)
        for k in ("box", "cls", "dfl"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=rtol, atol=1e-9)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=1e-5)
    state, start = run["state"], run["start"]
    params = flatten_variables(state.params, "params.")
    ema = flatten_variables(state.ema_params, "params.")
    stats = flatten_variables(state.batch_stats, "batch_stats.")
    keys, ours_ema = flax_keys(pm), tr.ema.state()
    floor = 1e-6 * max(np.abs(params[k] - start[k]).max() for k in params)
    for n, t in list(pm.named_parameters()) + list(pm.named_buffers()):
        if n not in keys:
            continue
        k = keys[n]
        got, base = _flax64(k, t), start[k].astype(np.float64)
        if k in stats:
            _close(got, stats[k], 1e-6, f"batch statistic {n}")
            continue
        _close(got - base, params[k] - base, 1e-5, f"change of {n}", atol=floor)
        _close(_flax64(k, ours_ema[n]) - base, ema[k] - base, 1e-5, f"EMA change of {n}",
               atol=floor + float(np.finfo(np.float32).eps) * np.abs(base).max())


def test_trainer_routing_of_the_tasks():
    """JAX's trainers: a segment or pose model takes the host pipeline even
    with `device_augment=True` (silently), its synthetic scenes at the full
    imgsz with their planes; `pose` and `kobj` are honoured gains;
    `overlap_mask` and `mask_ratio` stay refused; a dataset on disk, which
    has no planes, is refused."""
    pm = PoseModel(_config("pose"), device="cpu")
    tr = Trainer(pm, overrides={**STEP_OVERRIDES, "device_augment": True, "imgsz": 352,
                                "pose": 3.0, "kobj": 2.0}, steps_per_epoch=1000)
    assert tr.device_augment is False and not tr.loader.device_augment
    assert tr.loader.dataset.imgsz == 352 and tr.loader.dataset.task == "pose"
    assert (tr.criterion.pose_gain, tr.criterion.kobj_gain) == (3.0, 2.0)
    for key, value in (("overlap_mask", False), ("mask_ratio", 8)):
        with pytest.raises(ValueError, match=key):
            Trainer(pm, overrides={**STEP_OVERRIDES, key: value})
    with pytest.raises(ValueError, match="synthetic scenes only"):
        Trainer(SegmentationModel(_config("segment"), device="cpu"),
                overrides={**STEP_OVERRIDES, "data": "data.yaml"})


@pytest.mark.parametrize("task", sorted(TASKS))
def test_train_epoch_with_validation_and_plots(task, tmp_path):
    """One epoch through `Trainer.train()` with its validator and
    `plots=True`: the JAX trainer's two train-start plots, no validation
    plot (JAX's segment and pose validators draw none), finite losses and
    the task's metric keys."""
    pm = DetectionModel(TASKS[task].replace("v8-", "v8n-"), nc=2, device="cpu")
    tr = Trainer(pm, overrides={"epochs": 1, "batch": 2, "imgsz": 32, "amp": False,
                                "optimizer": "SGD", "plots": True},
                 save_dir=tmp_path, steps_per_epoch=1000)
    tr.loader.dataset.n = 4
    tr.val_loader = DataLoader(SyntheticDetectionDataset(n=2, imgsz=32, seed=1, task=task),
                               2, 32, train=False)
    results = tr.train()
    extra = "mask" if task == "segment" else "kpt"
    assert {"box_map50", f"{extra}_map50", "fitness"} <= set(results)
    assert all(np.isfinite(float(m["loss"])) for m in tr.history)
    assert (tmp_path / "labels.jpg").is_file() and (tmp_path / "train_batch0.jpg").is_file()
    assert not list(tmp_path.glob("val_batch0*"))
    meta = json.loads((tmp_path / "weights" / "last_metadata.json").read_text())
    back = DetectionModel.from_npz(tmp_path / "weights" / "last.npz", device="cpu")
    assert back.task == task and meta["model_yaml"] == pm.model_yaml


# ---------------------------------------------------------------------------
# validation, prediction, export, import
# ---------------------------------------------------------------------------

def test_matching_functions_match_jax():
    rng = np.random.default_rng(6)
    g, p = rng.random((4, 12, 10)) > 0.5, rng.random((7, 12, 10)) > 0.4
    np.testing.assert_array_equal(mask_iou_matrix(g, p), jax_mask_iou(g, p))
    gk = np.concatenate([rng.uniform(0, 64, (4, 17, 2)), rng.integers(0, 3, (4, 17, 1))], -1)
    pk = rng.uniform(0, 64, (7, 17, 3))
    areas = rng.uniform(10, 400, 4)
    sig = np.ones(17) / 17
    np.testing.assert_array_equal(kpt_oks_matrix(gk, pk, areas, sig),
                                  jax_oks(gk, pk, areas, sig))
    sim = rng.random((4, 7))
    gc, pc = rng.integers(0, 2, 4), rng.integers(0, 2, 7)
    iouv = np.linspace(0.5, 0.95, 10)
    want = jax_match(sim, gc, pc, iouv)
    np.testing.assert_array_equal(_match_by_matrix(sim, gc, pc, iouv), want)
    assert want.any()


@pytest.mark.parametrize("task", sorted(TASKS))
def test_validator_matches_jax(task, monkeypatch):
    """JAX's validator over its own loader of the synthetic validation
    scenes (the full imgsz, the task's planes) against the port's default
    loader of the same scenes, from the same variables: what each feeds its
    two `DetMetrics` (recorded on JAX's side), and the metric dicts."""
    import mgdt_yolo_tpu.engine.validator_seg_pose as jax_vsp
    made = []

    class Recording(jax_vsp.DetMetrics):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(jax_vsp, "DetMetrics", Recording)
    run = _run(task)
    pm = _port(task, run)
    args = {"imgsz": IMGSZ, "batch": 4, "conf": 0.001, "seed": 5}
    jax_cls = JaxSegmentationValidator if task == "segment" else JaxPoseValidator
    jm = run["jm"]
    jm.variables = _nest(run["start"])
    want = jax_cls(args=jax_get_cfg(overrides={**args, "task": task}))(jm)
    ours = (SegmentationValidator if task == "segment" else PoseValidator)(args)
    got = ours(pm)
    assert len(made) == 2 and set(got) == set(want)
    for mine, theirs in zip(ours.metrics, made):
        assert len(mine._tp) == len(theirs._tp) == 16
        for field in ("_tp", "_pcls", "_tcls"):
            for a, b in zip(getattr(mine, field), getattr(theirs, field)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(mine._conf, theirs._conf):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert any(t.any() for t in ours.metrics[0]._tp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    extra = "mask" if task == "segment" else "kpt"
    assert got["fitness"] == got["box_fitness"] and f"{extra}_map" in got
    with pytest.raises(ValueError, match=f"{task} model"):
        ours(DetectionModel("yolov8n.yaml", nc=2, device="cpu"))


@pytest.mark.parametrize("task", sorted(TASKS))
def test_predictor_takes_every_channel_as_a_class_as_jax(task):
    """JAX's predictor gives NMS no class count, so the mask coefficients or
    keypoints after the classes rank as class scores: the port computes the
    same, classes past nc included."""
    run = _run(task)
    # mask coefficients raised above the class scores (pose's decoded
    # keypoints, in pixels, are already)
    flat = {k: v + (3.0 if ".cv4_" in k and k.endswith("_2.bias") and task == "segment"
                    else 0.0) for k, v in run["start"].items()}
    pm = DetectionModel(_config(task), device="cpu")
    load_state(pm, load_jax_variables(flat))
    jm = run["jm"]
    imgs = [synthetic_scene(i, IMGSZ, seed=9) for i in range(3)]
    kw = {"imgsz": IMGSZ, "conf": 0.05}
    ours = DetectionPredictor(overrides={**kw, "device": "cpu"}).setup_model(pm)
    theirs = JaxPredictor(overrides={**kw, "save": False})
    theirs.setup_model(jm, _nest(flat))
    got, want = ours(imgs, batch=3), theirs(imgs, batch=3)
    assert _same_results(got, want) > 0
    assert max(float(r.boxes.cls.max()) for r in got if len(r)) >= pm.nc


@pytest.mark.parametrize("task", sorted(TASKS))
def test_npz_export_reload_and_reference_pt(task, tmp_path):
    """`YOLO(<yaml>).export(format="npz")` records the task; `YOLO(npz)` and
    `AutoBackend(npz)` rebuild the head and give the live decoded output
    bit for bit, as the segment model's `pt2` program does;
    a reference `.pt` written from the model reads back through the port's
    import and JAX's, every key (the `cv4` towers, `Proto`'s transposed
    conv, the Detect towers flat in the reference and nested under `detect`
    in flax)."""
    name = TASKS[task].replace("v8-", "v8n-")
    y = YOLO(name, device="cpu")
    assert y.task == task and y.model.task == task
    with torch.no_grad():
        for p in y.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.01)
    path = y.export(format="npz", imgsz=IMGSZ, project=str(tmp_path))[0]
    meta = json.loads(open(path.replace(".npz", "_metadata.json")).read())
    assert (meta["task"], meta["model_yaml"]) == (task, name)
    x = np.random.default_rng(3).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with torch.no_grad():
        live = y.model(torch.from_numpy(x))[0]
    reloaded = YOLO(path, device="cpu")
    assert reloaded.task == task and type(reloaded.model.model_22) is type(y.model.model_22)
    back = AutoBackend(path, imgsz=IMGSZ, device="cpu").forward(x)
    torch.testing.assert_close(back, live, rtol=0, atol=0)
    if task == "segment":  # the pt2 program gives the decoded tensor, as JAX's stablehlo
        pt2 = y.export(format="pt2", imgsz=IMGSZ, project=str(tmp_path))[0]
        torch.testing.assert_close(AutoBackend(pt2, imgsz=IMGSZ, device="cpu").forward(x), live,
                                   rtol=0, atol=0)
    pt = write_reference_pt(y.model, tmp_path / "ref.pt")
    model, _ = DetectionModel.from_pt(pt, device="cpu")
    rep = model.import_report
    assert rep["shape_missed"] == rep["name_missed"] == [] and model.task == task
    jm = JaxDetectionModel(name, nc=y.model.nc)
    jv, jrep = jax_load_state_dict(jm.variables, jax_load_torch_pt(str(pt))[0])
    assert jrep["matched"] == rep["matched"] and not jrep["name_missed"]
    want = flatten_variables(jax.device_get(jv))
    got = export_variables(model)
    assert set(got) == set(want) and any(".upsample." in k for k in got) == (task == "segment")
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)
    src = export_variables(y.model)
    np.testing.assert_array_equal(got["params.model_22.cv4_0_2.kernel"],
                                  src["params.model_22.cv4_0_2.kernel"].astype(np.float16)
                                  .astype(np.float32))
