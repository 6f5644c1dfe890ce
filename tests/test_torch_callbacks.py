"""The port's callback bus and its file loggers against the JAX package's,
on the CPU.

* The hook list is JAX's, hook for hook.
* Each engine fires JAX's hooks in JAX's order. The port's trainer trains
  for real (the flagship at 64 px, 2 epochs of 2 micro-batches, with
  validation, plots and the MLflow store); JAX's trainer runs its own loop
  with its train step, checkpoint writer and mesh replaced (hooks do not
  depend on what a step computes), as its validator runs with its compiled
  forward replaced, its predictor with a step that finds nothing, and its
  exporter for real (npz).
* `events.jsonl` rows equal JAX's for the same losses and metrics, `t`
  left out; the MLflow store's `params/`, `metrics/` and metas equal JAX's
  with times and ids masked; a trainer without a run directory writes
  nothing and does not raise.
"""
import json
import re
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

import mgdt_yolo_tpu.engine.trainer as jt
from mgdt_yolo_tpu.cfg import get_cfg
from mgdt_yolo_tpu.engine.exporter import Exporter as JaxExporter
from mgdt_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from mgdt_yolo_tpu.engine.validator import DetectionValidator as JaxValidator
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils import callbacks as jax_callbacks
from mgdt_yolo_tpu.utils import callbacks_integrations as jax_integrations
from mgdt_yolo_tpu_torch.data.build import DataLoader
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.engine.exporter import Exporter
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.engine.trainer import Trainer
from mgdt_yolo_tpu_torch.engine.validator import DetectionValidator
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.utils import callbacks, callbacks_integrations
from test_torch_train import NPZ, _nest, _npz
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMGSZ = 64
RUN = {"optimizer": "SGD", "lr0": 0.01, "batch": 2, "imgsz": IMGSZ, "epochs": 2,
       "workers": 1, "seed": 3}
TRAIN_HOOKS = ["on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
               "on_train_epoch_start", "on_train_batch_end", "on_train_epoch_end",
               "on_model_save", "on_fit_epoch_end", "on_train_end"]


def _record(engine, log):
    for hook in callbacks.HOOKS:
        engine.add_callback(hook, lambda e, h=hook: log.append(h))
    return log


def test_hook_list_is_jaxs():
    assert callbacks.HOOKS == jax_callbacks._HOOKS
    assert set(callbacks.get_default_callbacks()) == set(jax_callbacks.get_default_callbacks())


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's trainer over 4 scenes at batch 2 for 2 epochs, plots on,
    the MLflow store set, every hook recorded."""
    root = tmp_path_factory.mktemp("port_run")
    mp = pytest.MonkeyPatch()
    mp.setenv("MGDT_MLFLOW_DIR", str(root / "mlruns"))
    model = DetectionModel.from_npz(NPZ, device="cpu")
    loader = DataLoader(SyntheticDetectionDataset(n=4, imgsz=IMGSZ, seed=2), 2, IMGSZ, seed=3,
                        train=True, workers=1)
    val = DataLoader(SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=4), 2, IMGSZ, train=False)
    tr = Trainer(model, loader, overrides=RUN, save_dir=root / "run", val_loader=val)
    log = _record(tr, [])
    tr.train()
    mp.undo()
    return tr, log, root


@pytest.fixture(scope="module")
def jax_train_hooks(tmp_path_factory):
    """The hooks JAX's trainer fires over 2 epochs of 2 batches (64 scenes
    at batch 32), its step, checkpoint writer and mesh replaced."""
    project = tmp_path_factory.mktemp("jax_run")
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    jm.variables = _nest(_npz(NPZ))

    def make_train_step(*args, **kw):
        parts = {k: jnp.float32(v) for k, v in (("box", 1.0), ("cls", 2.0), ("dfl", 3.0))}
        return lambda state, batch: (state, parts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt, "make_train_step", make_train_step)
        mesh = jt.create_mesh
        mp.setattr(jt, "create_mesh", lambda: mesh(1))
        mp.setattr(jt.BaseTrainer, "save_checkpoint", lambda self, state, name: None)
        tr = jt.BaseTrainer(overrides={**RUN, "batch": 32, "val": False, "plots": False,
                                       "project": str(project), "name": "run"}, model=jm)
        log = _record(tr, [])
        tr.train()
    return log


def test_trainer_fires_jaxs_hooks_in_jaxs_order(port_run, jax_train_hooks):
    _, log, _ = port_run
    assert log == jax_train_hooks
    assert set(log) == set(TRAIN_HOOKS)
    assert log[:3] == TRAIN_HOOKS[:3] and log[-1] == "on_train_end"


def test_trainer_writes_jaxs_files(port_run):
    """events.jsonl one row per epoch with JAX's keys; the MLflow run's
    layout; the plots of `plots=True` at their sizes."""
    tr, _, root = port_run
    run = root / "run"
    rows = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    metric_keys = [k for k, v in tr.metrics.items() if isinstance(v, (int, float))]
    assert list(rows[-1]) == ["t", "epoch", "box_loss", "cls_loss", "dfl_loss", *metric_keys]
    assert rows[-1]["box_loss"] == pytest.approx(float(tr.loss_items["box_loss"]))
    (exp,) = [p for p in (root / "mlruns").iterdir() if p.is_dir()]
    (mrun,) = [p for p in exp.iterdir() if p.is_dir()]
    assert sorted(p.name for p in mrun.iterdir()) == ["artifacts", "meta.yaml", "metrics",
                                                       "params", "tags"]
    assert "status: 3" in (mrun / "meta.yaml").read_text()
    assert (mrun / "artifacts" / "last.npz").is_file()
    assert len((mrun / "metrics" / "train" / "box_loss").read_text().splitlines()) == 2
    sizes = {"labels.jpg": (1200, 1200), "train_batch0.jpg": (2 * IMGSZ, 2 * IMGSZ),
             "val_batch0_labels.jpg": (2 * IMGSZ, 2 * IMGSZ),
             "val_batch0_pred.jpg": (2 * IMGSZ, 2 * IMGSZ), "confusion_matrix.png": (840, 960)}
    for name, hw in sizes.items():
        assert cv2.imread(str(run / name)).shape[:2] == hw, name
    assert tr.plot_seconds > 0


def _fake(args, save_dir):
    """A trainer as the loggers see one: args, save_dir, and for each epoch
    its losses and metrics; hooks fired as the trainer fires them."""
    t = SimpleNamespace(args=args, save_dir=save_dir, epoch=0, loss_items={}, metrics={},
                        cbs={})
    t.add_callback = lambda ev, fn: t.cbs.setdefault(ev, []).append(fn)

    def fire(ev):
        for fn in t.cbs.get(ev, []):
            fn(t)
    t.fire = fire
    return t


def _drive(t, epochs):
    t.fire("on_pretrain_routine_start")
    t.fire("on_pretrain_routine_end")
    for e in range(epochs):
        t.epoch = e
        t.loss_items = {"box_loss": np.float32(1.5 - 0.1 * e), "cls_loss": np.float64(2.0),
                        "dfl_loss": 1.25}
        t.metrics = {"precision": 0.5 + e / 10, "recall": 0.25, "map50": 0.125,
                     "map": 0.0625 * (e + 1), "fitness": 0.1, "note": "skipped"}
        t.fire("on_fit_epoch_end")
    t.fire("on_train_end")


def _tree(root: Path):
    """{relative path: text} of a file store, run ids, experiment-dir
    URIs and millisecond times masked."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = re.sub(r"[0-9a-f]{32}", "<run>", str(p.relative_to(root)))
            text = p.read_text()
            text = re.sub(r"[0-9a-f]{32}", "<run>", text)
            text = re.sub(r"file://\S+", "<uri>", text)
            text = re.sub(r"\b1[0-9]{12}\b", "<ms>", text)
            out[rel] = text
    return out


def test_loggers_write_what_jaxs_write(tmp_path, monkeypatch):
    """The same run seen by both packages' loggers: events.jsonl rows
    without `t`, and the MLflow store (params from the full configuration:
    the port's dict args are JAX's `vars(args)`)."""
    monkeypatch.delenv("MLFLOW_EXPERIMENT_NAME", raising=False)
    over = {**RUN, "mosaic": 0.5, "name": "exp"}
    from mgdt_yolo_tpu_torch.engine.trainer import check_train_args
    for pkg, args, d in ((callbacks_integrations, check_train_args(over), "ours"),
                         (jax_integrations, get_cfg(overrides=over), "jax")):
        t = _fake(args, tmp_path / d / "run")
        pkg.JsonlLogger().attach(t)
        pkg.MlflowFileStoreLogger(root=tmp_path / d / "mlruns").attach(t)
        _drive(t, 3)
    rows = {d: [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in (tmp_path / d / "run" / "events.jsonl").read_text().splitlines()]
            for d in ("ours", "jax")}
    assert rows["ours"] == rows["jax"] and len(rows["ours"]) == 3
    ours, theirs = _tree(tmp_path / "ours" / "mlruns"), _tree(tmp_path / "jax" / "mlruns")
    assert ours == theirs
    params = {k for k in ours if "/params/" in k}
    assert len(params) == len(get_cfg().__dict__) and any(k.endswith("/params/mosaic")
                                                          for k in params)


def test_trainer_without_a_run_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MGDT_MLFLOW_DIR", str(tmp_path / "mlruns"))
    model = DetectionModel.from_npz(NPZ, device="cpu")
    loader = DataLoader(SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=2), 2, IMGSZ,
                        train=True, workers=1)
    tr = Trainer(model, loader, overrides={**RUN, "epochs": 1, "val": False})
    log = _record(tr, [])
    tr.train()
    assert log == TRAIN_HOOKS  # one epoch of one batch
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    jm.variables = _nest(_npz(NPZ))
    return jm


def _empty_dets(b):
    return np.zeros((b, 300, 6), np.float32), np.zeros((b,), np.int32)


def test_validator_predictor_exporter_fire_jaxs_hooks(jax_model, tmp_path, monkeypatch):
    model = DetectionModel.from_npz(NPZ, device="cpu")
    # validator
    v = DetectionValidator({"imgsz": IMGSZ, "batch": 2, "plots": False})
    ours_log = _record(v, [])
    v(model, DataLoader(SyntheticDetectionDataset(n=4, imgsz=IMGSZ, seed=1), 2, IMGSZ,
                        train=False))
    jv = JaxValidator(args=get_cfg(overrides={"imgsz": IMGSZ, "batch": 2, "plots": False}))
    jax_log = _record(jv, [])
    monkeypatch.setattr(jv, "cached_infer",
                        lambda mh, build: lambda vs, img: _empty_dets(len(img)))
    from mgdt_yolo_tpu.data.dataset import SyntheticDetectionDataset as JaxSynthetic
    jv(jax_model, jax_model.variables, dataset=JaxSynthetic(n=4, imgsz=IMGSZ, seed=1))
    assert ours_log == jax_log == ["on_val_start", "on_val_end"]
    # predictor: 3 images at batch 2
    imgs = [np.full((40, 56, 3), 90 + 20 * i, np.uint8) for i in range(3)]
    p = DetectionPredictor(overrides={"imgsz": IMGSZ, "device": "cpu"}).setup_model(model)
    ours_log = _record(p, [])
    items = []
    p.add_callback("on_predict_postprocess_end", lambda e: items.append(len(e.batch_items)))
    p(imgs, batch=2)
    jp = JaxPredictor(overrides={"imgsz": IMGSZ, "save": False})
    jp.setup_model(jax_model, jax_model.variables)
    jp._infer = lambda vs, x: _empty_dets(len(x))
    jax_log = _record(jp, [])
    jp(imgs, batch=2)
    assert ours_log == jax_log == ["on_predict_start", "on_predict_postprocess_end",
                                   "on_predict_postprocess_end", "on_predict_end"]
    assert items == [2, 1]
    # exporter
    e = Exporter({"format": "npz", "imgsz": IMGSZ, "project": str(tmp_path / "ours")})
    ours_log = _record(e, [])
    e(model)
    je = JaxExporter(overrides={"format": "npz", "imgsz": IMGSZ,
                                "project": str(tmp_path / "jax")})
    jax_log = _record(je, [])
    je(jax_model)
    assert ours_log == jax_log == ["on_export_start", "on_export_end"]
