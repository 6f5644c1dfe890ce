"""The port's training path against the JAX package's, in float32 on the CPU:
data and targets, BatchNorm's running statistics, the optimizer chain, the
flagship's loss and gradients, two whole train steps, and the checkpoint.

Tolerances, each with its reason:

* data, targets, groups and the exported weights: exact (same arithmetic);
* BatchNorm outputs 1e-5 and statistics 1e-6 (float32 reductions in
  another order);
* optimizer: 1e-5 relative, 1e-7 absolute on the parameters after every
  micro-step (elementwise float32 chains, the global norm summed in
  another order);
* flagship at 64 px (committed weights, windowed DCN on both sides): the
  loss to 1e-5 of its value; each parameter's gradient to 1e-3 of that
  tensor's largest gradient plus 1e-6 of the largest gradient of all
  (~60 layers of float32 convolutions and norms summed in another order
  by XLA and PyTorch, then back again; observed at most 3.5e-4 of a
  tensor's scale, and a few tensors whose gradient is ~1e-8, a rounding
  residue of a true 0, agree only to the absolute term);
* after two train steps: each parameter's and EMA's change from the
  start to 1e-3 of that tensor's largest change plus 4 float32 spacings
  of the parameter's magnitude (the change is a difference of two rounded
  parameters), batch statistics 1e-4;
* the checkpoint reloaded into the JAX model: raw maps 1e-4, as
  `tests/test_torch_model.py` holds the forward.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgdt_yolo_tpu.data.build import DataLoader as JaxDataLoader
from mgdt_yolo_tpu.data.build import collate as jax_collate
from mgdt_yolo_tpu.data.dataset import SyntheticDetectionDataset as JaxSynthetic
from mgdt_yolo_tpu.engine.trainer import TrainState, _decay_mask, make_train_step
from mgdt_yolo_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from mgdt_yolo_tpu.nn.modules import conv as JC
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils import yaml_load
from mgdt_yolo_tpu.utils.loss import DetectionLoss as JaxDetectionLoss
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.engine.trainer import Optimizer, Trainer
from mgdt_yolo_tpu_torch.nn.modules import conv as C
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, flax_keys,
                                         load_jax_variables, load_state, to_flax_layout)

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "weights" / "mgdt_n_synth.npz"
IMGSZ = 64


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _npz(path):
    with np.load(str(path)) as f:
        return {k: f[k] for k in f.files}


def _close(got, want, rel, what, atol=0.0):
    """max |got - want| <= rel * max |want| + atol (float32 arrays)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + atol, f"{what}: max |diff| {err:.3e}, max |want| {scale:.3e}"


# ---------------------------------------------------------------------------
# configuration and data
# ---------------------------------------------------------------------------

def test_train_defaults_match_yaml():
    yaml_cfg = yaml_load(ROOT / "mgdt_yolo_tpu/cfg/default.yaml")
    for k, v in TRAIN_DEFAULTS.items():
        assert yaml_cfg[k] == v, k


def test_synthetic_data_and_collate_match_jax():
    ours, theirs = SyntheticDetectionDataset(n=4, imgsz=96, seed=5), JaxSynthetic(
        n=4, imgsz=96, seed=5)
    for i in range(4):
        a, b = ours[i], theirs[i]
        for k in ("img", "boxes", "cls"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    loader = DataLoader(ours, 4, 96)
    assert loader.max_gt == JaxDataLoader(theirs, 4, 96, train=True).max_gt == 24
    got = collate([ours[i] for i in range(4)], 96, loader.max_gt)
    want = jax_collate([theirs[i] for i in range(4)], 96, loader.max_gt, train=True)
    for k in ("img", "gt_labels", "gt_bboxes", "mask_gt"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    batches = list(loader)
    assert len(batches) == 1 and batches[0]["img"].shape == (4, 96, 96, 3)


# ---------------------------------------------------------------------------
# BatchNorm in training mode
# ---------------------------------------------------------------------------

def test_batchnorm_running_stats_match_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32) * 2 + 0.5
    jmod = JC.Conv(16, 3)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = flatten_variables(variables)
    for k in flat:
        if k.endswith(("mean", "var", "scale", "bias")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    want, upd = jmod.apply(_nest(flat), jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = C.Conv(8, 16, 3)
    load_state(port, load_jax_variables(flat))
    port.train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    bs = upd["batch_stats"]["norm"]["bn"]
    np.testing.assert_allclose(port.norm.bn.running_mean.numpy(), np.asarray(bs["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.norm.bn.running_var.numpy(), np.asarray(bs["var"]),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the optimizer chain against optax
# ---------------------------------------------------------------------------

_TREE = {"conv": {"kernel": (3, 3, 4, 8), "bias": (8,)},
         "bn": {"scale": (8,), "bias": (8,)},
         "dense": {"kernel": (8, 6), "bias": (6,)},
         "dcn": {"weight": (3, 3, 4, 4)},
         "td": {"reduction_weight": (1, 1, 8, 4), "reduction_bias": (4,)},
         "grn": {"gamma": (1, 1, 1, 6), "beta": (1, 1, 1, 6)}}


def _tree_arrays(rng, scale=1.0):
    return {m: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in _TREE.items()}


def _flat(tree):
    return {f"{m}.{k}": v for m, leaves in tree.items() for k, v in leaves.items()}


# (name, accumulate, cos_lr, steps_per_epoch, epochs, nc): SGD and AdamW, with
# and without accumulation, linear and cosine decay, and `auto` both ways
OPT_CASES = [("SGD", 1, False, 3, 4, 2), ("SGD", 2, True, 4, 3, 2),
             ("AdamW", 1, True, 3, 4, 2), ("AdamW", 2, False, 4, 3, 2),
             ("auto", 1, False, 3, 4, 2), ("auto", 2, False, 6000, 2, 80)]


@pytest.mark.parametrize("case", OPT_CASES, ids=[f"{c[0]}-acc{c[1]}-cos{int(c[2])}-spe{c[3]}"
                                                 for c in OPT_CASES])
def test_optimizer_matches_optax(case):
    name, acc, cos_lr, spe, epochs, nc = case
    rng = np.random.default_rng(1)
    params = _tree_arrays(rng)
    kw = dict(lr0=0.05, lrf=0.1, momentum=0.937, weight_decay=0.01, warmup_steps=3 * acc,
              total_steps=spe * epochs, steps_per_epoch=spe, epochs=epochs, cos_lr=cos_lr,
              warmup_momentum=0.8, nc=nc, warmup_bias_lr=0.1, accumulate=acc)
    tx = jax_build_optimizer(params, name, **kw)
    state = tx.init(params)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    opt = Optimizer(tp, name, **kw)
    updated = 0
    for i in range(5 * acc):
        # steps 1 and 4 have gradients far above the clip norm of 10
        grads = _tree_arrays(rng, scale=30.0 if i in (1, 4) else 0.5)
        u, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, u)
        updated += opt.step([torch.from_numpy(v) for v in _flat(grads).values()])
        for k, v in _flat(jax.device_get(jp)).items():
            np.testing.assert_allclose(tp[k].numpy(), v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} after micro-step {i}")
    assert updated == opt.count == 5
    assert opt.name == {"auto": "SGD" if spe * epochs > 10000 else "AdamW"}.get(name, name)


def test_groups_follow_flax_names():
    """Decay and the bias group come from the flax names, not the torch
    names: BatchNorm's weight (flax `scale`) is neither decayed nor in the
    bias group; the DCN weight and `reduction_weight` are decayed."""
    pm = DetectionModel(device="cpu")
    keys = flax_keys(pm)
    params = dict(pm.named_parameters())
    opt = Optimizer({keys[n]: p for n, p in params.items()}, "SGD", 0.01, 0.01, 0.9, 5e-4,
                    100, 1000, 10, 100, False, 0.8)
    names = list(params)
    decayed = {names[i] for i in opt.decay}
    biased = {names[i] for i in opt.bias}
    jax_params = _nest(_npz(NPZ))["params"]
    flags = flatten_variables(jax.device_get(_decay_mask(jax_params)), "params.")
    assert {n for n in names if flags[keys[n]]} == decayed
    assert {n for n in names if keys[n].endswith(".bias")} == biased
    assert "model_0.norm.bn.weight" not in decayed | biased
    assert "model_0.norm.bn.bias" in biased
    assert "model_16.DyDCNV2.weight" in decayed
    assert "model_16.reg_decomp.reduction_weight" in decayed
    assert "model_16.reg_decomp.reduction_bias" not in decayed | biased
    assert len(keys) == 312 and len(params) == 218


# ---------------------------------------------------------------------------
# the flagship: loss, gradients and two train steps against JAX
# ---------------------------------------------------------------------------

OVERRIDES = {"optimizer": "SGD", "lr0": 0.1, "batch": 2, "nbs": 2, "epochs": 10,
             "warmup_epochs": 0.0, "amp": False}
STEPS_PER_EPOCH = 1000


def _jax_optimizer(params):
    a = {**TRAIN_DEFAULTS, **OVERRIDES}
    return jax_build_optimizer(
        params, "SGD", a["lr0"], a["lrf"], a["momentum"], a["weight_decay"],
        warmup_steps=100, total_steps=STEPS_PER_EPOCH * a["epochs"],
        steps_per_epoch=STEPS_PER_EPOCH, epochs=a["epochs"], cos_lr=False,
        warmup_momentum=a["warmup_momentum"], nc=2, warmup_bias_lr=a["warmup_bias_lr"],
        accumulate=1)


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship (windowed pin) from the committed weights, a batch
    of two labelled 64 px scenes, its loss and gradients at step 0, and the
    train state after two JAX train steps."""
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    variables = _nest(_npz(NPZ))
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=11)
    batch = collate([ds[i] for i in range(2)], IMGSZ, DataLoader(ds, 2, IMGSZ).max_gt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    crit = JaxDetectionLoss(jm.nc, jm.reg_max, jm.stride)
    img = jb["img"].astype(jnp.float32) / 255.0

    def loss_fn(params):
        out, upd = jm.model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  img, train=True, mutable=["batch_stats"])
        return crit(out[1], jb, 0).total
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])

    tx = _jax_optimizer(variables["params"])
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       ema_params=jax.tree.map(jnp.array, variables["params"]),
                       step=jnp.int32(0), ema_updates=jnp.int32(0))
    step_fn = make_train_step(jm.model, crit, tx)
    metrics = []
    for _ in range(2):
        state, m = step_fn(state, jb)
        metrics.append(jax.device_get(m))
    return {"batch": batch, "loss": float(loss),
            "grads": flatten_variables(jax.device_get(grads), "params."),
            "state": jax.device_get(state), "metrics": metrics, "jm": jm,
            "start": _npz(NPZ)}


def _port_model():
    return DetectionModel.from_npz(NPZ, device="cpu")


def test_flagship_loss_and_gradients_match_jax(flagship):
    pm = _port_model().train()
    assert pm.deform_semantics == "windowed"
    tr = Trainer(pm, overrides=OVERRIDES, steps_per_epoch=STEPS_PER_EPOCH)
    batch = to_device(flagship["batch"], "cpu")
    out = tr.criterion(pm.forward_feats(batch["img"].float() / 255.0), batch, 0)
    out.total.backward()
    np.testing.assert_allclose(out.total.item(), flagship["loss"], rtol=1e-5)
    keys = flax_keys(pm)
    floor = 1e-6 * max(np.abs(g).max() for g in flagship["grads"].values())
    for name, p in pm.named_parameters():
        want = flagship["grads"][keys[name]]
        got = np.zeros_like(want) if p.grad is None else to_flax_layout(keys[name], p.grad)
        _close(got, want, 1e-3, f"gradient of {name}", atol=floor)
    dcn = pm.model_16.DyDCNV2.weight.grad
    assert dcn is not None and float(dcn.abs().max()) > 0


def test_flagship_two_train_steps_match_jax(flagship):
    pm = _port_model()
    tr = Trainer(pm, overrides=OVERRIDES, steps_per_epoch=STEPS_PER_EPOCH)
    assert tr.accumulate == 1 and tr.optimizer.name == "SGD"
    batch = to_device(flagship["batch"], "cpu")
    metrics = [tr.train_step(batch) for _ in range(2)]
    for got, want in zip(metrics, flagship["metrics"]):
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=1e-3)
    state, start = flagship["state"], flagship["start"]
    assert int(state.step) == tr.step == 2 and int(state.ema_updates) == tr.ema.updates == 2
    params = flatten_variables(state.params, "params.")
    ema = flatten_variables(state.ema_params, "params.")
    stats = flatten_variables(state.batch_stats, "batch_stats.")
    keys = flax_keys(pm)
    ours_ema = tr.ema.state()
    for name, t in list(pm.named_parameters()) + list(pm.named_buffers()):
        if name not in keys:
            continue
        k = keys[name]
        if k in stats:
            _close(to_flax_layout(k, t), stats[k], 1e-4, f"batch statistic {name}")
            continue
        ulps = 4 * float(np.spacing(np.abs(start[k]).max()))
        _close(to_flax_layout(k, t) - start[k], params[k] - start[k], 1e-3,
               f"change of {name}", atol=ulps)
        _close(to_flax_layout(k, ours_ema[name]) - start[k], ema[k] - start[k], 1e-3,
               f"EMA change of {name}", atol=ulps)


def test_trainer_accumulates_before_stepping():
    """With accumulate 2 the first micro-batch changes no parameter and no
    EMA; the second steps both once (in warmup only the bias group moves)."""
    pm = _port_model()
    tr = Trainer(pm, overrides={**OVERRIDES, "nbs": 4}, steps_per_epoch=STEPS_PER_EPOCH)
    assert tr.accumulate == 2
    before = [p.detach().clone() for p in pm.parameters()]
    names = [n for n, _ in pm.named_parameters()]
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=11)
    batch = to_device(collate([ds[0], ds[1]], IMGSZ, 24), "cpu")
    tr.train_step(batch)
    assert all(torch.equal(a, b) for a, b in zip(before, pm.parameters()))
    assert tr.ema.updates == 0 and tr.optimizer.count == 0
    tr.train_step(batch)
    assert tr.ema.updates == 1 and tr.optimizer.count == 1
    assert not torch.equal(pm.model_16.cv2.bias, before[names.index("model_16.cv2.bias")])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_export_round_trips_the_committed_weights():
    flat = _npz(NPZ)
    got = export_variables(_port_model())
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_round_trip(tmp_path, flagship):
    """The trainer writes last.npz + last_metadata.json; the port reloads it
    pinned to the recorded semantics, and the JAX model loads the same npz
    and agrees with the port's forward."""
    pm = _port_model()
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=11)
    tr = Trainer(pm, DataLoader(ds, 2, IMGSZ), overrides={**OVERRIDES, "epochs": 1},
                 save_dir=tmp_path, steps_per_epoch=STEPS_PER_EPOCH)
    tr.train()
    path = tmp_path / "weights" / "last.npz"
    meta = json.loads((tmp_path / "weights" / "last_metadata.json").read_text())
    assert meta["deform_semantics"] == "windowed"
    assert (meta["epoch"], meta["step"], meta["ema_updates"]) == (0, 1, 1)
    back = DetectionModel.from_npz(path, device="cpu")
    assert back.deform_semantics == "windowed"
    for name, t in tr.ema.state().items():
        torch.testing.assert_close(dict(back.named_parameters())[name], t, rtol=0, atol=0)
    jm = flagship["jm"]
    variables = _nest(_npz(path))
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    _, want = jax.jit(lambda v, x: jm.model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        _, feats = back(torch.from_numpy(x))
    np.testing.assert_allclose(feats[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
