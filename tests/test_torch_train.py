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
from mgdt_yolo_tpu.engine.trainer import EarlyStopping as JaxEarlyStopping
from mgdt_yolo_tpu.engine.trainer import TrainState, _decay_mask, make_train_step
from mgdt_yolo_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from mgdt_yolo_tpu.engine.trainer import device_augment_unsupported as jax_unsupported
from mgdt_yolo_tpu.nn.modules import conv as JC
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils import yaml_load
from mgdt_yolo_tpu.ops.device_augment import device_augment as jax_device_augment
from mgdt_yolo_tpu.utils.loss import DetectionLoss as JaxDetectionLoss
from mgdt_yolo_tpu_torch.cfg.default import (CFG_DEFAULTS, NEUTRAL_KEYS, TRAIN_DEFAULTS,
                                            UNAUGMENTED)
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, collate_raw, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset, synthetic_batch
from mgdt_yolo_tpu_torch.engine.trainer import (EarlyStopping, Optimizer, Trainer,
                                                check_augment_args, device_augment_unsupported)
from mgdt_yolo_tpu_torch.ops.device_augment import apply_augment
from mgdt_yolo_tpu_torch.nn.modules import conv as C
from mgdt_yolo_tpu_torch.engine.validator import DetectionValidator
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.ops.nms import non_max_suppression
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, flax_keys,
                                         load_jax_variables, load_state, to_flax_layout)
from test_torch_augment import jax_draws

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
    """Every key has the JAX default but `device_augment`, the documented
    deviation: the JAX default selects the host (cv2) pipeline, not ported."""
    yaml_cfg = yaml_load(ROOT / "mgdt_yolo_tpu/cfg/default.yaml")
    for k, v in TRAIN_DEFAULTS.items():
        if k == "device_augment":
            assert v is True and yaml_cfg[k] is False
            continue
        assert yaml_cfg[k] == v, k


def test_port_key_set_is_the_yaml_key_set():
    """The port's copy of the JAX configuration: every key of default.yaml
    with its value; the honoured and the neutral keys are among them."""
    yaml_cfg = yaml_load(ROOT / "mgdt_yolo_tpu/cfg/default.yaml")
    assert list(CFG_DEFAULTS) == list(yaml_cfg) and CFG_DEFAULTS == yaml_cfg
    assert set(TRAIN_DEFAULTS) <= set(CFG_DEFAULTS) and set(NEUTRAL_KEYS) <= set(CFG_DEFAULTS)
    assert not set(TRAIN_DEFAULTS) & set(NEUTRAL_KEYS)


UNKNOWN_KEY_CASES = [{"lr": 0.5}, {"epoch": 3, "batch": 2}, {"zzz_not_a_key": 1},
                     {"lr": 0.5, "momentun": 0.9}]


@pytest.mark.parametrize("overrides", UNKNOWN_KEY_CASES,
                         ids=["lr", "epoch", "no-match", "two"])
def test_unknown_key_raises_as_jax(overrides):
    """An unknown key raises `SyntaxError` before anything is built, with
    the JAX message and suggestions (`lr` -> `lr0`) on the same overrides."""
    from mgdt_yolo_tpu.cfg import DEFAULT_CFG_DICT, check_dict_alignment as jax_alignment
    with pytest.raises(SyntaxError) as jax_err:
        jax_alignment(dict(DEFAULT_CFG_DICT, save_dir=None), overrides)
    with pytest.raises(SyntaxError) as err:
        Trainer(None, None, overrides={**UNAUGMENTED, **overrides})
    assert str(err.value) == str(jax_err.value)
    if "lr" in overrides:
        assert "lr0" in str(err.value)


# one key of each JAX type group (float, fraction, int, bool) with a bad value
TYPE_CASES = [("box", "7.5"), ("lr0", 1.5), ("hsv_s", "0.7"), ("epochs", 1.5),
              ("batch", "2"), ("val", 1), ("save", "yes")]


@pytest.mark.parametrize("key,value", TYPE_CASES, ids=[f"{k}={v!r}" for k, v in TYPE_CASES])
def test_type_errors_match_jax(key, value):
    """A value of the wrong type or range raises the JAX `check_cfg_types`
    error, type and message."""
    from mgdt_yolo_tpu.cfg import DEFAULT_CFG_DICT, check_cfg_types as jax_types
    with pytest.raises((TypeError, ValueError)) as jax_err:
        jax_types({**DEFAULT_CFG_DICT, key: value})
    with pytest.raises(type(jax_err.value)) as err:
        Trainer(None, None, overrides={key: value})
    assert str(err.value) == str(jax_err.value)


# the JAX keys the port does not honour yet, each at a value other than its
# default (`resume`, `single_cls`, `fraction`, `cache` and RMSProp are
# honoured since the from-disk path; `tests/test_torch_dataset.py` and
# `tests/test_torch_resume.py` check their behaviour)
UNHONOURED_CASES = [("rect", True), ("save_json", True), ("label_smoothing", 0.1),
                    ("device", "cuda:0"), ("dropout", 0.1), ("overlap_mask", False),
                    ("mask_ratio", 8), ("save_hybrid", True), ("tp", 2)]


@pytest.fixture(scope="module")
def cpu_model():
    return _port_model()


@pytest.mark.parametrize("key,value", UNHONOURED_CASES,
                         ids=[f"{k}={v!r}" for k, v in UNHONOURED_CASES])
def test_unhonoured_key_raises_and_its_default_builds(key, value, cpu_model):
    """A key the port does not honour raises, naming it, at a value other
    than the JAX default, and the Trainer builds at the default."""
    with pytest.raises(ValueError, match=key):
        Trainer(cpu_model, None, overrides={**OVERRIDES, key: value},
                steps_per_epoch=STEPS_PER_EPOCH)
    default = "cpu" if key == "device" else "SGD" if key == "optimizer" else CFG_DEFAULTS[key]
    tr = Trainer(cpu_model, None, overrides={**OVERRIDES, key: default},
                 steps_per_epoch=STEPS_PER_EPOCH)
    assert tr.args[key] == default


def test_agnostic_nms_is_honoured(cpu_model):
    """`agnostic_nms` is a key the trainer honours: the Trainer takes it, and
    its validator's NMS then lets boxes of any class suppress each other, as
    the JAX validator's does (`tests/test_torch_nms.py` holds that NMS to
    JAX's): on the same scenes it keeps fewer boxes than the NMS per class."""
    tr = Trainer(cpu_model, None, overrides={**OVERRIDES, "agnostic_nms": True},
                 steps_per_epoch=STEPS_PER_EPOCH)
    assert tr.args["agnostic_nms"] is True and TRAIN_DEFAULTS["agnostic_nms"] is False
    x = torch.from_numpy(synthetic_batch(2, imgsz=64))
    cpu_model.eval()
    with torch.no_grad():
        decoded, _ = cpu_model(x.float() / 255.0)
    counts = {}
    for agnostic in (False, True):
        det, counts[agnostic] = DetectionValidator({**tr.args, "agnostic_nms": agnostic}
                                                   ).infer(cpu_model, x)
        want = non_max_suppression(decoded, conf_thres=0.001, iou_thres=0.7, max_det=300,
                                   multi_label=True, agnostic=agnostic, pre_topk=4096,
                                   block=1024, nc=cpu_model.nc)
        torch.testing.assert_close(det, want[0], rtol=0, atol=0)
    assert (counts[True] < counts[False]).all() and (counts[True] > 0).all()
    cpu_model.train()


def test_neutral_keys_and_defaults_build(cpu_model):
    """The JAX defaults and `UNAUGMENTED` build; the keys that change
    neither weights nor metrics are taken at other values."""
    Trainer(cpu_model, None, steps_per_epoch=STEPS_PER_EPOCH)
    Trainer(cpu_model, None, overrides=UNAUGMENTED, steps_per_epoch=STEPS_PER_EPOCH)
    neutral = {"workers": 0, "verbose": False, "project": "p", "name": "n", "exist_ok": True,
               "device": "cpu", "plots": False}
    assert set(neutral) == set(NEUTRAL_KEYS)
    tr = Trainer(cpu_model, None, overrides={**OVERRIDES, **neutral},
                 steps_per_epoch=STEPS_PER_EPOCH)
    assert tr.optimizer.lr0 == OVERRIDES["lr0"]


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
             "warmup_epochs": 0.0, "amp": False, **UNAUGMENTED}
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

    def loss_fn(params, batch_stats, img, targets):
        out, upd = jm.model.apply({"params": params, "batch_stats": batch_stats},
                                  img, train=True, mutable=["batch_stats"])
        return crit(out[1], targets, 0).total
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))   # float32 images, 24 label slots
    loss, grads = grad_fn(variables["params"], variables["batch_stats"],
                          jb["img"].astype(jnp.float32) / 255.0,
                          {k: jb[k] for k in ("gt_labels", "gt_bboxes", "mask_gt")})

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
            "start": _npz(NPZ), "grad_fn": grad_fn, "crit": crit}


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


# the JAX defaults of the device augmentation, with left-right flips on
AUG = {"mosaic_p": 1.0, "scale": 0.5, "translate": 0.1, "fliplr": 0.5, "flipud": 0.0,
       "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4}


@pytest.fixture(scope="module")
def augmented_step(flagship):
    """JAX's augmented micro-step: `make_train_step` with the trainer's
    `augment_fn` (key folded with step 0) on a raw batch of two 64 px
    scenes; its metrics, JAX's augmented batch, the gradients on it, and
    JAX's draws of that key."""
    # fresh arrays: the train step donates its state's buffers
    jm, crit, variables = flagship["jm"], flagship["crit"], _nest(flagship["start"])
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=11)
    raw = collate_raw([ds[0], ds[1]], IMGSZ, 24)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}

    def augment_fn(batch, step):
        return jax_device_augment(batch, jax.random.fold_in(jax.random.PRNGKey(0), step),
                                  imgsz=IMGSZ, max_out=24, **AUG)
    tx = _jax_optimizer(variables["params"])
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       ema_params=jax.tree.map(jnp.array, variables["params"]),
                       step=jnp.int32(0), ema_updates=jnp.int32(0))
    _, metrics = jax.device_get(make_train_step(jm.model, crit, tx, augment_fn=augment_fn)(
        state, jraw))
    jaug = augment_fn(jraw, 0)
    variables = _nest(flagship["start"])
    loss, grads = flagship["grad_fn"](variables["params"], variables["batch_stats"], jaug["img"],
                                      {k: jaug[k] for k in ("gt_labels", "gt_bboxes", "mask_gt")})
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=1e-6)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in jax.device_get(jax_draws(key, 2, IMGSZ, *AUG.values())).items()}
    assert draws["use_mosaic"].all()
    return {"raw": raw, "metrics": metrics, "draws": draws,
            "batch": {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jaug).items()},
            "grads": flatten_variables(jax.device_get(grads), "params.")}


# (images, loss-part tolerance, gradient tolerance of scale): JAX's augmented
# batch handed to the port's step holds it at PR 2's step tolerances; the
# port's own `apply_augment` with JAX's draws differs from it at ~0.1% of
# the image values by up to 2/255 (tests/test_torch_augment.py), which
# moves the loss parts by up to 1e-4 of their value (observed 9e-5) and
# the gradients by up to ~1e-2 of a tensor's scale
AUG_STEP_CASES = [("jax-images", 1e-5, 1e-3), ("port-images", 3e-4, 3e-2)]


@pytest.mark.parametrize("case", AUG_STEP_CASES, ids=[c[0] for c in AUG_STEP_CASES])
def test_flagship_augmented_micro_step_matches_jax(case, augmented_step):
    """One float32 micro-step with device augmentation: JAX `make_train_step`
    with `augment_fn` against the port's `train_step` with an `augment_fn`:
    the loss parts, gradient norm and every gradient."""
    name, parts_tol, grad_tol = case
    want, grads = augmented_step["metrics"], augmented_step["grads"]
    if name == "jax-images":
        def augment_fn(b, step):
            return augmented_step["batch"]
    else:
        def augment_fn(b, step):
            return apply_augment(b, augmented_step["draws"], IMGSZ, 24)
    pm = _port_model()
    tr = Trainer(pm, overrides={**OVERRIDES, "device_augment": True},
                 steps_per_epoch=STEPS_PER_EPOCH, augment_fn=augment_fn)
    captured = {}

    def mark(stage):
        if stage == "backward":
            captured.update({n: p.grad.clone() for n, p in pm.named_parameters()
                             if p.grad is not None})
    got = tr.train_step(to_device(augmented_step["raw"], "cpu"), mark)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=parts_tol)
    np.testing.assert_allclose([got[k].item() for k in ("box", "cls", "dfl")],
                               np.asarray(want["parts"]), rtol=parts_tol)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                               rtol=max(grad_tol, 1e-3))
    keys = flax_keys(pm)
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    for n, p in pm.named_parameters():
        want_g = grads[keys[n]]
        got_g = to_flax_layout(keys[n], captured[n]) if n in captured else np.zeros_like(want_g)
        _close(got_g, want_g, grad_tol, f"gradient of {n}", atol=floor)


# ---------------------------------------------------------------------------
# the epoch loop's pieces
# ---------------------------------------------------------------------------

# (patience, fitness per epoch)
STOP_CASES = [(3, [0.1, 0.2, 0.2, 0.15, 0.1, 0.19, 0.3, 0.1, 0.1, 0.1]),
              (0, [0.5, 0.1, 0.1, 0.1]), (1, [0.0, 0.0, 0.1, 0.05])]


@pytest.mark.parametrize("case", STOP_CASES, ids=[f"patience{c[0]}" for c in STOP_CASES])
def test_early_stopping_matches_jax(case):
    patience, fits = case
    ours, theirs = EarlyStopping(patience), JaxEarlyStopping(patience)
    for epoch, fit in enumerate(fits):
        assert ours(epoch, fit) == theirs(epoch, fit)
        assert (ours.best_epoch, ours.best_fitness) == (theirs.best_epoch, theirs.best_fitness)


UNSUPPORTED_CASES = [{}, {"degrees": 10.0, "mixup": 0.3}, {"shear": 2.0},
                     {"mosaic9": 0.5, "copy_paste": 0.1, "perspective": 1e-4}]


@pytest.mark.parametrize("keys", UNSUPPORTED_CASES, ids=["none", "degrees-mixup", "shear",
                                                         "mosaic9-copy_paste-perspective"])
def test_device_augment_unsupported_matches_jax_and_raises(keys):
    """The same keys as the JAX guard; where JAX falls back to its host
    pipeline the port raises, and `device_augment=False` with any
    augmentation key set raises too."""
    from mgdt_yolo_tpu.cfg import get_cfg
    args = {**TRAIN_DEFAULTS, **keys}
    assert device_augment_unsupported(args) == jax_unsupported(
        get_cfg(overrides={**keys, "device_augment": True})) == keys
    if keys:
        with pytest.raises(ValueError, match="not ported"):
            Trainer(None, overrides=keys)
    else:
        check_augment_args(args)
    with pytest.raises(ValueError, match="host augmentation pipeline is not ported"):
        check_augment_args({**args, "device_augment": False})
    check_augment_args({**args, **UNAUGMENTED})


def test_close_mosaic_is_a_step_threshold():
    """As the JAX trainer's `augment_fn`: mosaic probability 0 from
    micro-step (epochs - close_mosaic) * nb on; no threshold without
    close_mosaic."""
    aug = {**OVERRIDES, "device_augment": True, "mosaic": 1.0, "scale": 0.5,
           "translate": 0.1, "imgsz": IMGSZ}
    pm = _port_model()
    tr = Trainer(pm, overrides={**aug, "epochs": 3, "close_mosaic": 1}, steps_per_epoch=2)
    assert tr.mosaic_off_step == (3 - 1) * 2
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=11)
    raw = to_device(collate_raw([ds[0], ds[1]], IMGSZ, 24), "cpu")
    used = []
    for step in (3, 4, 5):
        tr.augment(raw, step)
        used.append((bool(tr.draws["use_mosaic"].all()), bool(tr.draws["use_mosaic"].any())))
    assert used == [(True, True), (False, False), (False, False)]
    # the draws are a function of (seed, step)
    assert torch.equal(tr.augment(raw, 3)["img"], tr.augment(raw, 3)["img"])
    assert not torch.equal(tr.augment(raw, 3)["img"], tr.augment(raw, 4)["img"])
    assert Trainer(pm, overrides=aug, steps_per_epoch=2).mosaic_off_step is None


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


def test_cpu_train_with_augment_and_val(tmp_path):
    """Two epochs of the augmented path with validation on the CPU: a CSV
    row per epoch with the JAX header, `last` and `best` with the pin, and
    mosaic closed for the last epoch; a loader that does not ship raw
    batches is refused."""
    pm = _port_model()
    ds = SyntheticDetectionDataset(n=4, imgsz=IMGSZ, seed=2)
    over = {"optimizer": "SGD", "batch": 2, "epochs": 2, "imgsz": IMGSZ, "close_mosaic": 1,
            "amp": False}
    with pytest.raises(ValueError, match="device_augment"):
        Trainer(pm, DataLoader(ds, 2, IMGSZ), overrides=over)
    tr = Trainer(pm, DataLoader(ds, 2, IMGSZ, device_augment=True), overrides=over,
                 save_dir=tmp_path)
    results = tr.train()
    rows = (tmp_path / "results.csv").read_text().splitlines()
    assert rows[0] == "epoch,box_loss,cls_loss,dfl_loss,precision,recall,map50,map,fitness"
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(","))
    assert set(results) >= {"precision", "recall", "map50", "map", "fitness"}
    assert len(tr.history) == 4 and all(np.isfinite(float(m["loss"])) for m in tr.history)
    assert tr.mosaic_off_step == 2 and not tr.draws["use_mosaic"].any()
    for name in ("last", "best"):
        meta = json.loads((tmp_path / "weights" / f"{name}_metadata.json").read_text())
        assert meta["deform_semantics"] == "windowed" and "best_fitness" in meta
        assert DetectionModel.from_npz(tmp_path / "weights" / f"{name}.npz",
                                       device="cpu").deform_semantics == "windowed"
