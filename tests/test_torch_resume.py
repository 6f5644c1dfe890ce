"""The port's RMSProp, its training from a dataset on disk and its resume,
against the JAX package's, on the CPU (the flagship at 64 px from the
committed weights, windowed DCN on both sides, datasets of PNG frames
written here).

Tolerances, each with its reason:

* RMSProp against the optax chain: 1e-5 relative, 1e-7 absolute on the
  parameters after every micro-step, as the other optimizers are held
  (`tests/test_torch_train.py`: float32 chains, the global norm summed in
  another order);
* an interrupted and resumed run against the same run uninterrupted: bit
  for bit (the same arithmetic in the same order on the same CPU);
* one RMSProp `Trainer` step against JAX: the loss 1e-5 and gradient
  norm 1e-3 relative, the gradients (read from the moment RMSProp keeps)
  to the limit `tests/test_torch_train.py` holds gradients to;
* the port's resumed run against JAX's resumed run (orbax), SGD over two
  micro-steps: each parameter's and EMA's change from the start to
  1e-3 of that tensor's largest change plus 4 float32 spacings of the
  parameter's magnitude, batch statistics 1e-4, the two train steps'
  limits of `tests/test_torch_train.py`.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgdt_yolo_tpu.engine.trainer import BaseTrainer as JaxTrainer
from mgdt_yolo_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu_torch.cfg.default import AUGMENT_KEYS, TRAIN_DEFAULTS
from mgdt_yolo_tpu_torch.engine.trainer import Optimizer, Trainer, resume_state_path
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.weights import flatten_variables, flax_keys, to_flax_layout
from test_torch_dataset import write_dataset, write_yaml
from test_torch_train import NPZ, _close, _flat, _nest, _npz, _tree_arrays
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMGSZ = 64
TRAIN_SIZES = [(48, 64), (80, 60), (100, 100), (37, 53), (64, 64), (120, 70)]
VAL_SIZES = [(60, 90), (96, 72)]


class Interrupted(Exception):
    """Raised by a test to cut a run at an epoch's start."""


# ---------------------------------------------------------------------------
# RMSProp against optax
# ---------------------------------------------------------------------------

# (accumulate, cos_lr, steps_per_epoch, epochs, warmup micro-steps)
RMS_CASES = [(1, False, 3, 4, 3), (2, True, 4, 3, 6), (1, True, 2, 5, 1)]


@pytest.mark.parametrize("case", RMS_CASES, ids=[f"acc{c[0]}-cos{int(c[1])}-warm{c[4]}"
                                                 for c in RMS_CASES])
def test_rmsprop_matches_optax(case):
    """JAX's `optax.rmsprop(lr_schedule, momentum=momentum)` after the
    scale and clip, in `MultiSteps` where accumulating: every parameter
    after every micro-step, gradients above the clip norm included."""
    acc, cos_lr, spe, epochs, warm = case
    rng = np.random.default_rng(2)
    params = _tree_arrays(rng)
    kw = dict(lr0=0.05, lrf=0.1, momentum=0.937, weight_decay=0.01, warmup_steps=warm,
              total_steps=spe * epochs, steps_per_epoch=spe, epochs=epochs, cos_lr=cos_lr,
              warmup_momentum=0.8, nc=2, warmup_bias_lr=0.1, accumulate=acc)
    tx = jax_build_optimizer(params, "RMSProp", **kw)
    state = tx.init(params)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    opt = Optimizer(tp, "RMSProp", **kw)
    assert opt.kind == "rmsprop" and opt.decay and opt.bias  # groups exist, unused
    update = jax.jit(tx.update)
    updated = 0
    for i in range(6 * acc):
        grads = _tree_arrays(rng, scale=30.0 if i in (1, 4) else 0.5)
        u, state = update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, u)
        updated += opt.step([torch.from_numpy(v) for v in _flat(grads).values()])
        for k, v in _flat(jax.device_get(jp)).items():
            np.testing.assert_allclose(tp[k].numpy(), v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} after micro-step {i}")
    assert updated == opt.count == 6


def test_rmsprop_trainer_step_matches_jax():
    """One `Trainer` micro-step with RMSProp on the flagship against JAX's
    loss, gradients and optax update: the loss and gradient norm as the
    two train steps hold them, the parameters unmoved (the warmup's rate is
    0 at the first update, in both), and the squared-gradient moment,
    read back as |gradient| (sqrt(nu / 0.1)), within the gradients' limit
    of `tests/test_torch_train.py` (1e-3 of each tensor's largest plus 1e-6
    of the largest of all)."""
    from mgdt_yolo_tpu.utils.loss import DetectionLoss as JaxDetectionLoss
    from mgdt_yolo_tpu_torch.data.build import collate, to_device
    from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
    from test_torch_train import OVERRIDES, STEPS_PER_EPOCH
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    variables = _nest(_npz(NPZ))
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=11)
    batch = collate([ds[i] for i in range(2)], IMGSZ, 24)
    crit = JaxDetectionLoss(jm.nc, jm.reg_max, jm.stride)

    def loss_fn(params):
        out, _ = jm.model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(batch["img"], jnp.float32) / 255.0, train=True,
                                mutable=["batch_stats"])
        return crit(out[1], {k: jnp.asarray(batch[k])
                             for k in ("gt_labels", "gt_bboxes", "mask_gt")}, 0).total
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    over = {**OVERRIDES, "optimizer": "RMSProp"}
    a = {**TRAIN_DEFAULTS, **over}
    tx = jax_build_optimizer(variables["params"], "RMSProp", a["lr0"], a["lrf"], a["momentum"],
                             a["weight_decay"], warmup_steps=100,
                             total_steps=STEPS_PER_EPOCH * a["epochs"],
                             steps_per_epoch=STEPS_PER_EPOCH, epochs=a["epochs"], cos_lr=False,
                             warmup_momentum=a["warmup_momentum"], nc=2, accumulate=1)
    u, state = jax.jit(tx.update)(grads, tx.init(variables["params"]), variables["params"])
    nu = [leaf for leaf in jax.tree.leaves(state) if hasattr(leaf, "shape")]
    want_nu = flatten_variables(jax.device_get(
        jax.tree.unflatten(jax.tree.structure(variables["params"]),
                           nu[:len(jax.tree.leaves(variables["params"]))])), "params.")
    assert all(float(jnp.abs(x).max()) == 0 for x in jax.tree.leaves(u))

    pm = DetectionModel.from_npz(NPZ, device="cpu")
    tr = Trainer(pm, overrides=over, steps_per_epoch=STEPS_PER_EPOCH)
    start = {n: p.detach().clone() for n, p in pm.named_parameters()}
    m = tr.train_step(to_device(batch, "cpu"))
    np.testing.assert_allclose(m["loss"].item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jax.jit(optax.global_norm)(grads)), rtol=1e-3)
    keys = flax_keys(pm)
    gmax = {k: np.sqrt(v / 0.1) for k, v in want_nu.items()}
    floor = 1e-6 * max(float(g.max()) for g in gmax.values())
    for (name, p), nu_t in zip(pm.named_parameters(), tr.optimizer.nu):
        assert torch.equal(p, start[name]), name
        k = keys[name]
        _close(np.sqrt(to_flax_layout(k, nu_t) / 0.1), gmax[k], 1e-3, f"|gradient| of {name}",
               atol=floor)


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("pigs")
    write_dataset(root, TRAIN_SIZES, "train")
    write_dataset(root, VAL_SIZES, "val", seed=1)
    return write_yaml(root)


def _overrides(data_yaml, project, **kw):
    return {"data": str(data_yaml), "batch": 2, "imgsz": IMGSZ, "epochs": 2, "amp": False,
            "project": str(project), "workers": 2, "lr0": 0.01, **kw}


def _interrupt_at(trainer, epoch):
    """Cut `trainer`'s run at the start of `epoch` (its checkpoints of the
    epochs before are written)."""
    set_epoch = trainer.loader.set_epoch

    def cut(e):
        if e == epoch:
            raise Interrupted
        set_epoch(e)
    trainer.loader.set_epoch = cut


def _state(tr):
    """A copy of every tensor of a trainer's training state, and its counts."""
    out = {k: t.detach().clone() for k, t in tr.train_state().items()}
    return out, (tr.step, tr.ema.updates, tr.optimizer.count, tr.optimizer.mini_step)


# (optimizer, nbs, val): SGD accumulating 2 over 3 micro-steps an epoch, so
# the cut falls between a micro-step and its update; RMSProp and AdamW
RESUME_CASES = [("SGD", 4, False), ("RMSProp", 2, True), ("AdamW", 2, False)]


@pytest.mark.parametrize("case", RESUME_CASES, ids=[c[0] for c in RESUME_CASES])
def test_resume_is_bit_for_bit(data_yaml, tmp_path, case):
    """Two epochs run whole equal one epoch, a cut, and a resume, bit for
    bit: parameters, batch statistics, EMA, optimizer moments and
    accumulation, the counts, and the losses and metrics of the last epoch;
    the resumed state equals the saved one before its first step. On the
    device pipeline: the host pipeline's mosaic buffer starts empty on a
    resume, as JAX's does, so its batches after a cut are not the whole
    run's."""
    name, nbs, val = case
    kw = {"optimizer": name, "nbs": nbs, "val": val, "device_augment": True}
    whole = Trainer(DetectionModel.from_npz(NPZ, device="cpu"),
                    overrides=_overrides(data_yaml, tmp_path / "whole", **kw),
                    save_dir=tmp_path / "whole" / "run")
    whole.train()
    cut = Trainer(DetectionModel.from_npz(NPZ, device="cpu"),
                  overrides=_overrides(data_yaml, tmp_path / "cut", **kw),
                  save_dir=tmp_path / "cut" / "run")
    _interrupt_at(cut, 1)
    with pytest.raises(Interrupted):
        cut.train()
    saved, saved_counts = _state(cut)
    assert name != "SGD" or saved_counts[3] == 1  # cut between a micro-step and its update
    resumed = Trainer(DetectionModel.from_npz(NPZ, device="cpu"),
                      overrides=_overrides(data_yaml, tmp_path / "cut", resume=True, **kw),
                      save_dir=tmp_path / "cut" / "run")
    assert resumed.resume_path == tmp_path / "cut" / "run" / "weights" / "last.npz"
    assert resumed.start_epoch == 1 and resumed.model.names == {0: "piglet", 1: "sow"}
    got, got_counts = _state(resumed)
    assert got_counts == saved_counts and set(got) == set(saved)
    for k in saved:
        assert torch.equal(got[k], saved[k]), f"restored {k}"
    resumed.train()
    a, a_counts = _state(whole)
    b, b_counts = _state(resumed)
    assert a_counts == b_counts
    for k in a:
        assert torch.equal(a[k], b[k]), f"{k} after the resumed epoch"
    rows = [(p / "run" / "results.csv").read_text().splitlines() for p in
            (tmp_path / "whole", tmp_path / "cut")]
    assert rows[0] == rows[1] and len(rows[0]) == 3
    assert resumed.best_fitness == whole.best_fitness


def test_resume_pin_conflict_and_no_checkpoint(data_yaml, tmp_path, caplog):
    """A model pinned to other deform semantics than the checkpoint's
    refuses to resume, as JAX refuses a conflicting MGDT_DEFORM_EXACT;
    resume with no checkpoint under `project` warns and starts fresh."""
    kw = {"optimizer": "SGD", "nbs": 2, "val": False, "epochs": 1}
    tr = Trainer(DetectionModel.from_npz(NPZ, device="cpu"),
                 overrides=_overrides(data_yaml, tmp_path, **kw), save_dir=tmp_path / "run")
    tr.train()
    meta = json.loads((tmp_path / "run" / "weights" / "last_metadata.json").read_text())
    assert meta["names"] == {"0": "piglet", "1": "sow"} and meta["optimizer"]["count"] == 3
    assert resume_state_path(tmp_path / "run" / "weights" / "last.npz").is_file()
    back = DetectionModel.from_npz(tmp_path / "run" / "weights" / "last.npz", device="cpu")
    assert back.names == {0: "piglet", 1: "sow"}
    exact = DetectionModel.from_npz(NPZ, device="cpu").set_deform_semantics("exact")
    with pytest.raises(RuntimeError, match="WINDOWED"):
        Trainer(exact, overrides=_overrides(data_yaml, tmp_path, resume=True, **kw))
    fresh = Trainer(DetectionModel.from_npz(NPZ, device="cpu"),
                    overrides=_overrides(data_yaml, tmp_path / "empty", resume=True, **kw))
    assert fresh.start_epoch == 0 and fresh.resume_path is None
    assert any("no checkpoint found" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# the resumed run against JAX's
# ---------------------------------------------------------------------------

# the JAX defaults, device augment with every augmentation at 0 (the raw
# canvases, so no random draw decides anything) and SGD, whose changes the
# two train steps' limits hold (RMSProp's, each element's gradient over
# its own root mean square, turn a gradient's relative rounding into a
# change as large as the largest: its step is held above)
JAX_RUN = {"optimizer": "SGD", "lr0": 0.01, "batch": 2, "nbs": 2, "imgsz": IMGSZ, "epochs": 2,
           "val": False, "device_augment": True, "seed": 0, "workers": 2,
           **dict.fromkeys(AUGMENT_KEYS, 0.0)}


@pytest.fixture(scope="module")
def pair_yaml(tmp_path_factory):
    """Two train images: one micro-step an epoch."""
    root = tmp_path_factory.mktemp("pair")
    write_dataset(root, TRAIN_SIZES[1:3], "train", seed=3)
    write_dataset(root, VAL_SIZES, "val", seed=1)
    return write_yaml(root)


@pytest.fixture(scope="module")
def jax_resumed(pair_yaml, tmp_path_factory):
    """JAX's BaseTrainer on two images: epoch 0, a cut at the start of
    epoch 1, then `resume=True` for epoch 1; the final train state. The
    JAX trainer runs on one of the tests' 8 CPU devices, and the resumed run
    reuses the first run's compiled train step (the same model, loss,
    optimizer and augmentation settings), which leaves JAX's restore of the
    state as it is and saves a compile (a state restored from orbax enters
    the step as the first run's initial state did; a step's output state
    would need a compile of its own, so each run takes one step)."""
    import mgdt_yolo_tpu.engine.trainer as jt
    project = tmp_path_factory.mktemp("jax_runs")

    def model():
        jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
        jm.set_deform_semantics("windowed")
        jm.variables = _nest(_npz(NPZ))
        return jm

    steps = []

    def make_train_step(*args, **kw):
        if not steps:
            steps.append(make(*args, **kw))
        return steps[0]

    over = {**JAX_RUN, "data": str(pair_yaml), "project": str(project), "name": "run",
            "exist_ok": True, "plots": False}
    make, mesh = jt.make_train_step, jt.create_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt, "make_train_step", make_train_step)
        mp.setattr(jt, "create_mesh", lambda: mesh(1))
        first = JaxTrainer(overrides=over, model=model())

        def cut(trainer):
            if trainer.epoch == 1:
                raise Interrupted
        first.add_callback("on_train_epoch_start", cut)
        with pytest.raises(Interrupted):
            first.train()
        second = JaxTrainer(overrides={**over, "resume": True}, model=model())
        second.train()
    assert second.start_epoch == 1 and len(steps) == 1
    return jax.device_get(second.state)


def test_resumed_run_matches_jax(pair_yaml, tmp_path, jax_resumed):
    """The same cut and resume through the port, one micro-step before the
    cut and one after it: the second reads the restored momentum trace."""
    over = _overrides(pair_yaml, tmp_path, **{k: v for k, v in JAX_RUN.items()
                                              if k != "workers"})
    first = Trainer(DetectionModel.from_npz(NPZ, device="cpu"), overrides=over,
                    save_dir=tmp_path / "run")
    _interrupt_at(first, 1)
    with pytest.raises(Interrupted):
        first.train()
    tr = Trainer(DetectionModel.from_npz(NPZ, device="cpu"),
                 overrides={**over, "resume": True}, save_dir=tmp_path / "run")
    tr.train()
    state = jax_resumed
    assert int(state.step) == tr.step == 2 and int(state.ema_updates) == tr.ema.updates == 2
    assert tr.optimizer.count == 2
    start = _npz(NPZ)
    params = flatten_variables(state.params, "params.")
    ema = flatten_variables(state.ema_params, "params.")
    stats = flatten_variables(state.batch_stats, "batch_stats.")
    keys = flax_keys(tr.model)
    ours_ema = tr.ema.state()
    for name, t in list(tr.model.named_parameters()) + list(tr.model.named_buffers()):
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
