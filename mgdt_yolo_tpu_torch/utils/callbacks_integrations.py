"""The loggers on the callback bus, a copy of the JAX package's
`mgdt_yolo_tpu/utils/callbacks_integrations.py`, attached to every training
run by `add_integration_callbacks`:

- `JsonlLogger`: `<save_dir>/events.jsonl`, one line per epoch (losses and
  validation metrics), always.
- `TensorBoardLogger`: scalars through `torch.utils.tensorboard` (or
  `tensorboardX`) where either imports.
- `MlflowFileStoreLogger`: MLflow's file-store layout written directly, no
  package or server, where `MGDT_MLFLOW_DIR` or `MLFLOW_TRACKING_URI` (a
  local path or `file:` URI) is set; http(s) URIs are refused.
- `WandbOfflineLogger`: wandb in its offline mode, where `MGDT_WANDB=1` or
  `WANDB_MODE=offline` is set and `wandb` imports; inert otherwise.

The trainer's arguments are the port's dict: a logger reads the full JAX
configuration, `cfg.default.CFG_DEFAULTS` updated by them, where JAX reads
`vars(trainer.args)`, so MLflow's `params/` hold JAX's keys and values. A
trainer without a `save_dir` has no run directory: then no logger writes.
"""
from __future__ import annotations

import json
import logging
import os
import time
import uuid
from pathlib import Path

from ..cfg.default import CFG_DEFAULTS

LOGGER = logging.getLogger(__name__)


def trainer_args(trainer) -> dict:
    """The full configuration of `trainer`'s run, as JAX's `vars(args)`."""
    args = trainer.args
    return {**CFG_DEFAULTS, **(args if isinstance(args, dict) else vars(args))}


def _save_dir(trainer):
    sd = getattr(trainer, "save_dir", None)
    return None if sd is None else Path(sd)


class JsonlLogger:
    """Writes one JSON line per epoch: losses + val metrics."""

    def __init__(self):
        self.file = None

    def attach(self, trainer):
        trainer.add_callback("on_pretrain_routine_start", self._start)
        trainer.add_callback("on_fit_epoch_end", self._epoch)
        trainer.add_callback("on_train_end", self._end)

    def _start(self, trainer):
        sd = _save_dir(trainer)
        if sd is None:
            return
        self.file = sd / "events.jsonl"
        self.file.parent.mkdir(parents=True, exist_ok=True)

    def _epoch(self, trainer):
        if self.file is None:
            return
        row = {"t": time.time(), "epoch": getattr(trainer, "epoch", -1),
               **{k: float(v) for k, v in getattr(trainer, "loss_items", {}).items()},
               **{k: float(v) for k, v in getattr(trainer, "metrics", {}).items()
                  if isinstance(v, (int, float))}}
        with open(self.file, "a") as f:
            f.write(json.dumps(row) + "\n")

    def _end(self, trainer):
        if self.file is not None:
            LOGGER.info(f"metrics stream: {self.file}")


class TensorBoardLogger:
    """Scalar writer where a TensorBoard backend imports."""

    def __init__(self):
        self.writer = None

    def attach(self, trainer):
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        except ImportError:
            try:
                from tensorboardX import SummaryWriter  # noqa: F401
            except ImportError:
                LOGGER.info("tensorboard writer unavailable; JSONL logging only")
                return
        self._SummaryWriter = SummaryWriter
        trainer.add_callback("on_pretrain_routine_start", self._start)
        trainer.add_callback("on_fit_epoch_end", self._epoch)

    def _start(self, trainer):
        sd = _save_dir(trainer)
        if sd is not None:
            self.writer = self._SummaryWriter(str(sd))

    def _epoch(self, trainer):
        if self.writer is None:
            return
        step = getattr(trainer, "epoch", 0)
        for k, v in getattr(trainer, "loss_items", {}).items():
            self.writer.add_scalar(f"train/{k}", float(v), step)
        for k, v in getattr(trainer, "metrics", {}).items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(f"val/{k}", float(v), step)


class MlflowFileStoreLogger:
    """MLflow tracking without the mlflow package: the file store's on-disk
    layout (one directory per experiment and run, `metrics/<key>` files of
    "timestamp value step" lines, `params/<key>` files of one value, flat
    YAML metas), written directly. Parameters at pretrain end, metrics each
    fit epoch, the weight files at train end; keys sanitised as mlflow
    does.
    """

    def __init__(self, root=None):
        uri = root or os.environ.get("MGDT_MLFLOW_DIR") or \
            os.environ.get("MLFLOW_TRACKING_URI", "")
        uri = str(uri)
        if uri.startswith(("http://", "https://")):
            LOGGER.warning("mlflow http tracking URIs are not supported "
                           "(offline file-store only) — mlflow logging off")
            uri = ""
        if uri.startswith("file:"):
            uri = uri[5:].lstrip("/") if uri.startswith("file:///") else uri[5:]
            uri = ("/" + uri) if not uri.startswith("/") else uri
        self.root = Path(uri) if uri else None
        self.run_dir = None

    def attach(self, trainer):
        if self.root is None:
            return
        trainer.add_callback("on_pretrain_routine_end", self._start)
        trainer.add_callback("on_fit_epoch_end", self._epoch)
        trainer.add_callback("on_train_end", self._end)

    @staticmethod
    def _sanitize(key: str) -> str:
        # mlflow rejects '(', ')' and ':' in keys
        return key.replace("(", "").replace(")", "").replace(":", "-")

    def _write_meta(self, path: Path, meta: dict):
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:  # flat scalar YAML
            for k, v in meta.items():
                f.write(f"{k}: {v}\n")

    def _experiment_id(self, exp_name: str) -> str:
        """One experiment directory per name, across processes: an existing
        one is found by its `meta.yaml`'s `name:`, else the id is derived
        from sha1(name), so concurrent first writers agree."""
        if self.root.is_dir():
            for meta in self.root.glob("*/meta.yaml"):
                for line in meta.read_text().splitlines():
                    if line.startswith("name: ") and line[6:] == exp_name:
                        return meta.parent.name
        import hashlib
        digest = hashlib.sha1(exp_name.encode()).hexdigest()
        return str(int(digest[:12], 16) % 10 ** 9)

    def _start(self, trainer):
        if _save_dir(trainer) is None:
            return
        args = trainer_args(trainer)
        exp_name = os.environ.get("MLFLOW_EXPERIMENT_NAME", f"/mgdt/{args.get('task', 'detect')}")
        exp_id = self._experiment_id(exp_name)
        exp_dir = self.root / exp_id
        if not (exp_dir / "meta.yaml").exists():
            self._write_meta(exp_dir / "meta.yaml", {
                "artifact_location": exp_dir.as_uri(), "experiment_id": exp_id,
                "lifecycle_stage": "active", "name": exp_name})
        run_id = uuid.uuid4().hex
        self.run_dir = exp_dir / run_id
        self.t0 = int(time.time() * 1000)
        run_name = str(trainer.save_dir).rsplit("/", 1)[-1]
        for d in ("metrics", "params", "tags", "artifacts"):
            (self.run_dir / d).mkdir(parents=True, exist_ok=True)
        self._write_meta(self.run_dir / "meta.yaml", {
            "artifact_uri": (self.run_dir / "artifacts").as_uri(),
            "end_time": "null", "entry_point_name": "''",
            "experiment_id": exp_id, "lifecycle_stage": "active",
            "run_id": run_id, "run_name": run_name, "run_uuid": run_id,
            "source_name": "''", "source_type": 4, "source_version": "''",
            "start_time": self.t0, "status": 1,
            "user_id": os.environ.get("USER", "mgdt")})
        (self.run_dir / "tags" / "mlflow.runName").write_text(run_name)
        for k, v in args.items():
            (self.run_dir / "params" / self._sanitize(str(k))).write_text(str(v))
        LOGGER.info(f"mlflow file-store run: {self.run_dir}")

    def _epoch(self, trainer):
        if self.run_dir is None:
            return
        step = int(getattr(trainer, "epoch", 0))
        ts = int(time.time() * 1000)
        rows = {**{f"train/{k}": v for k, v in getattr(trainer, "loss_items", {}).items()},
                **{k: v for k, v in getattr(trainer, "metrics", {}).items()
                   if isinstance(v, (int, float))}}
        for k, v in rows.items():
            p = self.run_dir / "metrics" / self._sanitize(k)
            p.parent.mkdir(parents=True, exist_ok=True)
            with open(p, "a") as f:
                f.write(f"{ts} {float(v)} {step}\n")

    def _end(self, trainer):
        if self.run_dir is None:
            return
        wdir = Path(str(trainer.save_dir)) / "weights"
        art = self.run_dir / "artifacts"
        if wdir.is_dir():
            import shutil
            for item in wdir.iterdir():
                try:
                    if item.is_dir():
                        shutil.copytree(item, art / item.name, dirs_exist_ok=True)
                    else:
                        shutil.copy2(item, art / item.name)
                except OSError as e:
                    LOGGER.warning(f"mlflow artifact copy failed: {e}")
        # finalise the run's meta (status 3 = FINISHED)
        meta = (self.run_dir / "meta.yaml").read_text().splitlines()
        done = {"end_time": int(time.time() * 1000), "status": 3}
        out = [f"{k}: {done.pop(k)}" if (k := line.split(":", 1)[0]) in done else line
               for line in meta]
        (self.run_dir / "meta.yaml").write_text("\n".join(out) + "\n")


class WandbOfflineLogger:
    """wandb, always in its offline mode (`wandb.init(mode="offline")`,
    synced later with `wandb sync`): its offline format cannot be written
    without the package. Active only where `MGDT_WANDB=1` or
    `WANDB_MODE=offline` is set and `wandb` imports."""

    def __init__(self, wandb_module=None):
        self.wb = wandb_module
        self.run = None
        if self.wb is None:
            if not (os.environ.get("MGDT_WANDB") or os.environ.get("WANDB_MODE") == "offline"):
                return
            try:
                import wandb
                assert hasattr(wandb, "__version__")
                self.wb = wandb
            except (ImportError, AssertionError):
                LOGGER.info("wandb not importable; wandb logging off")

    def attach(self, trainer):
        if self.wb is None:
            return
        trainer.add_callback("on_pretrain_routine_start", self._start)
        trainer.add_callback("on_fit_epoch_end", self._epoch)
        trainer.add_callback("on_train_end", self._end)

    def _start(self, trainer):
        sd = _save_dir(trainer)
        if sd is None:
            return
        args = trainer_args(trainer)
        self.run = self.wb.init(project=str(args.get("project") or "MGDT"),
                                name=str(args.get("name") or "train"), config=args,
                                mode="offline", dir=str(sd))

    def _epoch(self, trainer):
        if self.run is None:
            return
        step = int(getattr(trainer, "epoch", 0)) + 1
        rows = {**{f"train/{k}": float(v) for k, v in getattr(trainer, "loss_items", {}).items()},
                **{k: float(v) for k, v in getattr(trainer, "metrics", {}).items()
                   if isinstance(v, (int, float))}}
        self.run.log(rows, step=step)

    def _end(self, trainer):
        if self.run is None:
            return
        best = Path(str(trainer.save_dir)) / "weights" / "best.npz"
        try:
            if best.exists():
                art = self.wb.Artifact(type="model", name=f"run_{self.run.id}_model")
                art.add_file(str(best))
                self.run.log_artifact(art)
        finally:
            self.run.finish()


def add_integration_callbacks(trainer):
    """Attach every available logger to `trainer`."""
    JsonlLogger().attach(trainer)
    TensorBoardLogger().attach(trainer)
    MlflowFileStoreLogger().attach(trainer)
    WandbOfflineLogger().attach(trainer)
