"""Training two models of the ablation matrix in the port against the JAX
package on the CPU: `yolov8` (the reg_max-4 `Detect` head on three levels)
and `thead_yolov8` (TOOD on the stride-16 map, its DCN at C 64 through the
plain backward; layers 19-21 run and reach no head). Then checkpoints of
the ablation models, in both directions.

Both sides start from JAX's seeded variables with randomised norm
statistics, scales and biases; the JAX models are pinned to the windowed
DCN. From this start JAX's own float32 training forward strays from its
float64 function by up to 4e-3 (`yolov8`) and 2e-2 (`thead`) of a tensor's
gradient scale, where the port's float32 strays 2e-4 and 1e-4 (measured
on these inputs): so the JAX reference runs in float64 (`jax.enable_x64`),
and the port is held to it twice, in float64 (the same function) and in
float32 (the type it trains in). The loss itself is float32 on both sides
at every type. Tolerances, each with its reason:

* float64: the loss to 1e-6 of its value, each part to 1e-6 of the largest
  part; each parameter's gradient to 1e-5 of that tensor's largest gradient
  plus 1e-6 of the largest gradient of all (the float32 loss's rounding
  carried back; observed at most 4e-6); a parameter whose output reaches
  no head has no gradient in the port and an all-zero one in JAX;
* the port in float32: the loss to 1e-5, each gradient to 1e-3 of its
  tensor's scale plus the same floor (float32 rounding through ~60 layers,
  as `tests/test_torch_train.py` holds the flagship's);
* after two SGD steps in float64 (the first one's learning rate is 0 in
  warmup, so kernels move from the second on): each parameter's and EMA's
  change to 1e-5 of that tensor's largest change plus 1e-6 of the largest
  change of all (the gradients' floor, carried by the step), batch
  statistics 1e-6; the EMA's change also plus one float32 spacing of 1
  times the parameter's magnitude (its decay d is a float32 number on both
  sides, and JAX rounds 1 - d to float32 too). The weight decay is 0.05 (the JAX default is 5e-4), so
  that it moves the kernels of layers 19-21, which get no gradient, by
  thousands of float32 spacings;
* checkpoints: the exported arrays exactly; reloaded raw maps 1e-4 of their
  magnitude (at least 1), as `tests/test_torch_ablation.py` holds them.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.trainer import TrainState, make_train_step
from mgdt_yolo_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils.loss import DetectionLoss as JaxDetectionLoss
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS, UNAUGMENTED
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.engine.trainer import Trainer
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, flax_keys,
                                         load_jax_variables, load_state, save_npz)
from test_torch_ablation import RTOL_RAW
from test_torch_model import _randomize
from test_torch_train import _nest, _npz
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (model, image size): thead at 128 px, so its DCN map is 8x8
MODELS = {"yolov8.yaml": 64, "thead_yolov8.yaml": 128}
DEAD = ("model_19.", "model_20.", "model_21.")   # thead's layers that reach no head


def _dead(name):
    """The prefixes of the model's layers whose output reaches no head."""
    return DEAD if name == "thead_yolov8.yaml" else ()
OVERRIDES = {"optimizer": "SGD", "lr0": 0.1, "weight_decay": 0.05, "batch": 2, "nbs": 2,
             "epochs": 10, "warmup_epochs": 0.0, "amp": False, **UNAUGMENTED}
STEPS_PER_EPOCH = 1000


def _jax_optimizer(params):
    a = {**TRAIN_DEFAULTS, **OVERRIDES}
    return jax_build_optimizer(
        params, "SGD", a["lr0"], a["lrf"], a["momentum"], a["weight_decay"],
        warmup_steps=100, total_steps=STEPS_PER_EPOCH * a["epochs"],
        steps_per_epoch=STEPS_PER_EPOCH, epochs=a["epochs"], cos_lr=False,
        warmup_momentum=a["warmup_momentum"], nc=2, warmup_bias_lr=a["warmup_bias_lr"],
        accumulate=1)


def _close(got, want, rel, what, atol=0.0):
    """max |got - want| <= rel * max |want| + atol, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + atol, f"{what}: max |diff| {err:.3e}, max |want| {scale:.3e}"


def _flax(key, t):
    """A port tensor in flax's layout for `key`, in float64."""
    a = t.detach().double().numpy()
    if key.endswith(".kernel"):
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return a


_RUNS = {}


def _run(name):
    """A float32 JAX model (nc=2, windowed pin) for eval forwards, its
    starting variables (flat, float32), a batch of two labelled scenes,
    JAX's float64 loss, parts and gradients there, and JAX's float64 train
    state after two train steps. Built once per model."""
    if name in _RUNS:
        return _RUNS[name]
    imgsz = MODELS[name]
    jm = JaxDetectionModel(name, nc=2)
    jm.set_deform_semantics("windowed")
    start = _randomize(jm.variables, seed=3)
    ds = SyntheticDetectionDataset(n=2, imgsz=imgsz, seed=11)
    batch = collate([ds[i] for i in range(2)], imgsz, DataLoader(ds, 2, imgsz).max_gt)
    run = {"jm": jm, "start": start, "batch": batch, "imgsz": imgsz}
    with jax.enable_x64(True):
        j64 = JaxDetectionModel(name, nc=2, dtype=jnp.float64)
        j64.set_deform_semantics("windowed")
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(start))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        crit = JaxDetectionLoss(j64.nc, j64.reg_max, j64.stride)

        def loss_fn(params, batch_stats, img, targets):
            out, _ = j64.model.apply({"params": params, "batch_stats": batch_stats},
                                     img, train=True, mutable=["batch_stats"])
            lo = crit(out[1], targets, 0)
            return lo.total, lo.parts
        (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"],
            jb["img"].astype(jnp.float64) / 255.0,
            {k: jb[k] for k in ("gt_labels", "gt_bboxes", "mask_gt")})
        run.update(loss=float(loss), parts=np.asarray(parts),
                   grads=flatten_variables(jax.device_get(grads), "params."))
        tx = _jax_optimizer(variables["params"])
        state = TrainState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           ema_params=jax.tree.map(jnp.array, variables["params"]),
                           step=jnp.int32(0), ema_updates=jnp.int32(0))
        step_fn = make_train_step(j64.model, crit, tx)
        run["metrics"] = []
        for _ in range(2):
            state, m = step_fn(state, jb)
            run["metrics"].append(jax.device_get(m))
        run["state"] = jax.device_get(state)
    _RUNS[name] = run
    return run


def _port(name, run, dtype=torch.float32):
    pm = DetectionModel(name, nc=2, device="cpu")
    load_state(pm, load_jax_variables(run["start"]))
    return pm.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_match_jax(name, dtype):
    run = _run(name)
    pm = _port(name, run, dtype).train()
    tr = Trainer(pm, overrides=OVERRIDES, steps_per_epoch=STEPS_PER_EPOCH)
    assert (tr.criterion.reg_max, tr.criterion.strides) == (run["jm"].reg_max, run["jm"].stride)
    batch = to_device(run["batch"], "cpu")
    out = tr.criterion(pm.forward_feats(batch["img"].to(dtype) / 255.0), batch, 0)
    out.total.backward()
    exact = dtype == torch.float64
    np.testing.assert_allclose(out.total.item(), run["loss"], rtol=1e-6 if exact else 1e-5)
    if exact:
        np.testing.assert_allclose(out.parts.numpy(), run["parts"], rtol=0,
                                   atol=1e-6 * run["parts"].max())
    keys = flax_keys(pm)
    floor = 1e-6 * max(np.abs(g).max() for g in run["grads"].values())
    for n, p in pm.named_parameters():
        want = run["grads"][keys[n]]
        if n.startswith(_dead(name)):
            assert p.grad is None and not want.any(), n
            continue
        got = np.zeros_like(want) if p.grad is None else _flax(keys[n], p.grad)
        _close(got, want, 1e-5 if exact else 1e-3, f"gradient of {n}", atol=floor)
    if name == "thead_yolov8.yaml":
        dcn = pm.model_22.DyDCNV2
        assert dcn.weight.shape == (3, 3, 64, 64)
        assert float(dcn.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_two_train_steps_match_jax(name):
    """Parameters, EMA and batch statistics after two float64 steps; for
    thead, layers 19-21 (no gradient; weight decay and BatchNorm statistics
    still move them) among them."""
    run = _run(name)
    pm = _port(name, run, torch.float64)
    tr = Trainer(pm, overrides=OVERRIDES, steps_per_epoch=STEPS_PER_EPOCH)
    batch = to_device(run["batch"], "cpu")
    metrics = [tr.train_step(batch) for _ in range(2)]
    for got, want in zip(metrics, run["metrics"]):
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=1e-5)
    state, start = run["state"], run["start"]
    assert int(state.step) == tr.step == 2 and int(state.ema_updates) == tr.ema.updates == 2
    params = flatten_variables(state.params, "params.")
    ema = flatten_variables(state.ema_params, "params.")
    stats = flatten_variables(state.batch_stats, "batch_stats.")
    keys, ours_ema = flax_keys(pm), tr.ema.state()
    floor = 1e-6 * max(np.abs(params[k] - start[k]).max() for k in params)
    dead_moved = set()
    for n, t in list(pm.named_parameters()) + list(pm.named_buffers()):
        if n not in keys:
            continue
        k = keys[n]
        got, base = _flax(k, t), start[k].astype(np.float64)
        if k in stats:
            _close(got, stats[k], 1e-6, f"batch statistic {n}")
            if n.startswith(_dead(name)):
                assert np.abs(got - base).max() > 0, n
                dead_moved.add(n.split(".")[0])
            continue
        mine = _flax(k, ours_ema[n])
        _close(got - base, params[k] - base, 1e-5, f"change of {n}", atol=floor)
        _close(mine - base, ema[k] - base, 1e-5, f"EMA change of {n}",
               atol=floor + float(np.finfo(np.float32).eps) * np.abs(base).max())
        if n.startswith(_dead(name)) and k.endswith(".kernel"):
            spacing = float(np.spacing(np.float32(np.abs(base).max())))
            assert np.abs(got - base).max() > 1000 * spacing, n
    # model_20 is a Concat
    assert dead_moved == ({"model_19", "model_21"} if _dead(name) else set())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jax_forward(run, flat, x):
    jm = run["jm"]
    return jax.jit(lambda v, x: jm.model.apply(v, x, train=False))(_nest(flat), jnp.asarray(x))


def _same_maps(feats, want):
    for got, w in zip(feats, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=RTOL_RAW * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_checkpoints_load_both_ways(tmp_path, name):
    """A port checkpoint (the port's own init) loads in JAX with the same
    output; JAX's variables written as a checkpoint naming the config load
    through `from_npz` as that config and `nc`, with the same output."""
    run = _run(name)
    x = np.random.default_rng(4).uniform(0, 1, (2, run["imgsz"], run["imgsz"], 3)
                                         ).astype(np.float32)
    pm = DetectionModel(name, nc=2, device="cpu")
    meta = {"model_yaml": name, "nc": 2, "deform_semantics": "windowed"}
    path = save_npz(pm, tmp_path / "port.npz", meta)
    flat = _npz(path)
    assert set(flat) == set(run["start"])
    _, want = _jax_forward(run, flat, x)
    with torch.no_grad():
        _, feats = pm(torch.from_numpy(x))
    _same_maps(feats, want)

    np.savez(str(tmp_path / "jax.npz"), **run["start"])
    (tmp_path / "jax_metadata.json").write_text(json.dumps(meta))
    back = DetectionModel.from_npz(tmp_path / "jax.npz", device="cpu")
    assert (back.model_yaml, back.nc, back.stride) == (name, 2, run["jm"].stride)
    for k, v in export_variables(back).items():
        np.testing.assert_array_equal(v, run["start"][k], err_msg=k)
    _, want = _jax_forward(run, run["start"], x)
    with torch.no_grad():
        _, feats = back(torch.from_numpy(x))
    _same_maps(feats, want)


@pytest.mark.parametrize("name", ["yolov8.yaml", "thead_yolov8.yaml", "gd_yolov8.yaml"])
def test_trainer_checkpoint_rebuilds_its_config(tmp_path, name):
    """One epoch of `Trainer.train()` with its validation; then
    `Trainer.save_checkpoint` has recorded the config and `nc`, and
    `from_npz` rebuilds that model (not the flagship) holding the EMA
    parameters and the trainer's batch statistics."""
    imgsz = 64
    pm = DetectionModel(name, nc=3, device="cpu")
    ds = SyntheticDetectionDataset(n=2, imgsz=imgsz, seed=11)
    tr = Trainer(pm, DataLoader(ds, 2, imgsz), save_dir=tmp_path,
                 overrides={**OVERRIDES, "epochs": 1, "imgsz": imgsz},
                 steps_per_epoch=STEPS_PER_EPOCH)
    results = tr.train()
    assert set(results) >= {"precision", "recall", "map50", "map", "fitness"}
    assert all(np.isfinite(v) for v in results.values())
    meta = json.loads((tmp_path / "weights" / "last_metadata.json").read_text())
    assert (meta["model_yaml"], meta["nc"]) == (name, 3)
    back = DetectionModel.from_npz(tmp_path / "weights" / "last.npz", device="cpu")
    assert (back.model_yaml, back.nc, back.stride, back.reg_max) == \
        (name, 3, pm.stride, pm.reg_max)
    for n, t in tr.ema.state().items():
        torch.testing.assert_close(dict(back.named_parameters())[n], t, rtol=0, atol=0)
    for (n, b), (_, src) in zip(back.named_buffers(), pm.named_buffers()):
        torch.testing.assert_close(b, src, rtol=0, atol=0, msg=n)


def test_from_npz_falls_back_to_the_flagship_only_without_a_config(tmp_path):
    """Metadata with no `model_yaml` (or none at all) builds the flagship;
    metadata naming another config than the weights' raises."""
    flagship = DetectionModel(nc=2, device="cpu")
    save_npz(flagship, tmp_path / "a.npz", {"deform_semantics": "windowed"})
    np.savez(str(tmp_path / "c.npz"), **export_variables(flagship))
    for stem in ("a", "c"):
        assert DetectionModel.from_npz(tmp_path / f"{stem}.npz", device="cpu").model_yaml == \
            "mspa_c2f_gd_tood_yolov8.yaml"
    save_npz(flagship, tmp_path / "b.npz", {"model_yaml": "gd_thead_yolov8.yaml", "nc": 2})
    with pytest.raises(KeyError, match="do not fit"):
        DetectionModel.from_npz(tmp_path / "b.npz", device="cpu")


@pytest.mark.parametrize("name,scale,recorded", [("thead_yolov8.yaml", "s", "thead_yolov8s.yaml"),
                                                 ("yolov8n.yaml", "s", "yolov8s.yaml")])
def test_scale_argument_checkpoint_round_trip(tmp_path, name, scale, recorded):
    """A model built with `scale=` records that scale in the config it names,
    as JAX names a scale ("thead_yolov8s.yaml"), so `Trainer.save_checkpoint`
    and `from_npz` give back the same model with equal weights."""
    pm = DetectionModel(name, scale=scale, nc=2, device="cpu")
    assert pm.model_yaml == recorded
    tr = Trainer(pm, None, save_dir=tmp_path, overrides=OVERRIDES,
                 steps_per_epoch=STEPS_PER_EPOCH)
    tr.save_checkpoint("last")
    back = DetectionModel.from_npz(tmp_path / "weights" / "last.npz", device="cpu")
    assert (back.model_yaml, back.nc, back.stride) == (recorded, 2, pm.stride)
    want = dict(pm.state_dict())
    assert set(back.state_dict()) == set(want)
    for k, v in back.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_checkpoint_of_a_config_dict_is_refused(tmp_path):
    """A model built from a dict of no file cannot name its config, so the
    Trainer refuses to save its checkpoints before training."""
    from mgdt_yolo_tpu_torch.models import CONFIGS
    pm = DetectionModel(CONFIGS["yolov8.yaml"], nc=2, device="cpu")
    assert pm.model_yaml is None
    with pytest.raises(ValueError, match="config dict"):
        Trainer(pm, None, save_dir=tmp_path, overrides=OVERRIDES,
                steps_per_epoch=STEPS_PER_EPOCH)
    tr = Trainer(pm, None, overrides=OVERRIDES, steps_per_epoch=STEPS_PER_EPOCH)
    tr.save_dir = tmp_path
    with pytest.raises(ValueError, match="config dict"):
        tr.save_checkpoint("last")
    assert not (tmp_path / "weights").exists()
