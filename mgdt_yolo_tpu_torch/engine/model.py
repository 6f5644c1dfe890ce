"""The `YOLO` facade: one object that trains, validates, predicts, serves,
exports and benchmarks a detection model; the counterpart of the JAX
package's `mgdt_yolo_tpu/engine/model.py`, for the detect, segment and pose
tasks (`TASK_MAP`, as JAX's: `DetectionPredictor` serves all three).

`YOLO(model="yolov8n.yaml", task=None, device=None)` builds the model on
`device` (CUDA by default; `device="cpu"` for the CPU) from:

* the YAML file name of a config of `models.CONFIGS` (the port's seeded
  init), or
* an `.npz` weight archive with its `<stem>_metadata.json` (the committed
  `weights/mgdt_n_synth.npz`, the port's checkpoints, the JAX exporter's
  archives), through `DetectionModel.from_npz`, pinned to the deform
  semantics the metadata records, or
* a reference `.pt` checkpoint (the fork's pickled module graph), through
  `DetectionModel.from_pt`: the config its `train_args` name, the EMA
  weights, pinned to exact deform semantics as the JAX facade pins them;
  the checkpoint is kept as `ckpt`.

The task is the `task` given, else the one the model's name implies
(`guess_model_task`: "-seg" segment, "-pose" pose), as JAX's facade
takes it; it picks the validator. Refused: a JAX orbax checkpoint
directory (the JAX package's `YOLO(...).export(format="npz")` carries one
across), and the classify task (ROADMAP queue 1, item 8). `track` (item 9)
raises.

Every method takes configuration keys as keyword arguments, over the
facade's own (`model`, `task`), in JAX's cascade `{**self.overrides,
**kwargs}`. `predict` serves a Conv+BN-folded copy of the model, so the
facade's model keeps its BatchNorm and can be trained after a prediction,
as in JAX; `train` runs `engine.trainer.Trainer` on the model in place,
with checkpoints under `project/name` (runs/detect/train, incremented),
and then puts the EMA parameters into it, as JAX's facade adopts them.
"""
from __future__ import annotations

import copy
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from ..cfg import get_cfg
from ..cfg.default import CFG_DEFAULTS
from ..device import parse_device
from ..nn.autobackend import load_npz_model
from ..nn.tasks import DetectionModel, PoseModel, SegmentationModel, guess_model_task
from .predictor import DetectionPredictor
from .trainer import Trainer
from .validator import DetectionValidator
from .validator_seg_pose import PoseValidator, SegmentationValidator

LOGGER = logging.getLogger(__name__)
# the Trainer takes its task from the model's head
TASK_MAP: Dict[str, list] = {
    "detect": [DetectionModel, Trainer, DetectionValidator, DetectionPredictor],
    "segment": [SegmentationModel, Trainer, SegmentationValidator, DetectionPredictor],
    "pose": [PoseModel, Trainer, PoseValidator, DetectionPredictor]}
# the keys the facade resolves itself: they select the model, not a setting
FACADE_KEYS = ("model", "task", "mode")


def _not_ported_task(task: str) -> NotImplementedError:
    return NotImplementedError(f"the {task} task is not ported: the port runs detect, segment "
                               f"and pose (classify: ROADMAP queue 1, item 8)")


class YOLO:
    """The model facade; see the module's text."""

    def __init__(self, model: Union[str, Path] = "yolov8n.yaml", task: Optional[str] = None,
                 device=None):
        self.predictor = self.trainer = self.validator = None
        self.overrides: Dict[str, Any] = {}
        self.ckpt = None
        model = str(model)
        self.task = task or guess_model_task(model)
        if self.task not in TASK_MAP:
            raise _not_ported_task(self.task)
        self.device = parse_device(device)
        if model.endswith((".yaml", ".yml")):
            self.model = TASK_MAP[self.task][0](model, device=self.device)
        else:
            self.model = self._load(model)
        self.overrides.setdefault("model", self.model.model_yaml or model)
        self.overrides["task"] = self.task

    def _load(self, weights: str) -> DetectionModel:
        p = Path(weights)
        if p.is_dir():
            raise ValueError(
                f"{weights!r} is a directory, as the JAX trainer's orbax checkpoints are: the "
                f"port reads npz archives; carry it across with the JAX package's "
                f"YOLO({weights!r}).export(format='npz')")
        if p.suffix == ".pt" and p.is_file():
            model, pt = DetectionModel.from_pt(p, self.device)
            self.ckpt = pt.ckpt
            self.overrides["model"] = pt.train_args.get("model") or "yolov8n.yaml"
            return model
        if p.suffix == ".npz" and p.is_file():
            return load_npz_model(p, self.device)[0]
        raise FileNotFoundError(f"cannot load model from {weights!r}")

    def _overrides(self, kwargs: Dict) -> Dict[str, Any]:
        """JAX's cascade `{**self.overrides, **kwargs}`, for a ported task."""
        overrides = {**self.overrides, **kwargs}
        if overrides["task"] not in TASK_MAP:
            raise _not_ported_task(overrides["task"])
        return overrides

    def _args(self, kwargs: Dict, mode: str) -> Dict[str, Any]:
        """The cascade's configuration keys, checked by `get_cfg`, without
        the facade's own (other keys are dropped, as JAX's facade drops them)."""
        known = {k: v for k, v in self._overrides(kwargs).items() if k in CFG_DEFAULTS}
        get_cfg(None, {**known, "mode": mode})
        return {k: v for k, v in known.items() if k not in FACADE_KEYS}

    # ---- modes -----------------------------------------------------------
    def train(self, **kwargs) -> Dict[str, float]:
        """Train the model (in place) and adopt the EMA parameters; returns
        the last validation's results."""
        args = {k: v for k, v in self._overrides(kwargs).items() if k not in FACADE_KEYS}
        from ..utils.settings import increment_path
        save_dir = increment_path(Path(args.get("project") or "runs/detect") /
                                  (args.get("name") or "train"),
                                  exist_ok=bool(args.get("exist_ok")))
        trainer = TASK_MAP[self.task][1](self.model, overrides=args, save_dir=save_dir)
        metrics = trainer.train()
        self.trainer, self.predictor = trainer, None
        ema = trainer.ema.state()
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(ema[name])
        self.model.eval()
        return metrics

    def val(self, save_dir=None, **kwargs) -> Dict[str, float]:
        """Validate the model on the `val` split of `data` (the synthetic
        validation set when it is None); with `save_json`, predictions.json
        goes to `save_dir` (the working directory by default, as JAX's)."""
        args = self._args(kwargs, "val")
        if save_dir is not None:
            args["save_dir"] = str(save_dir)
        self.validator = TASK_MAP[self.task][2](args)
        return self.validator(self.model)

    def predict(self, source=None, stream: bool = False, **kwargs):
        """`Results` of every image of `source` (a generator with `stream`),
        `batch` images a forward (1 by default), from a folded copy of the
        model; the predictor is kept until the next call with keywords."""
        args = self._args(kwargs, "predict")
        args.setdefault("device", str(self.device))
        if self.predictor is None or kwargs:
            self.predictor = TASK_MAP[self.task][3](args).setup_model(
                copy.deepcopy(self.model))
        return self.predictor(source, stream=stream, batch=int(kwargs.get("batch", 1)))

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream=stream, **kwargs)

    def serve(self, **kwargs):
        """A started micro-batching `InferenceServer` over the model."""
        from .serve import InferenceServer
        kwargs.setdefault("device", self.device)
        return InferenceServer(self.model, **kwargs).start()

    def export(self, **kwargs):
        """[path] of the model exported as `format` (`pt2` by default, or
        `npz`; `engine/exporter.py`)."""
        from .exporter import Exporter
        kwargs.setdefault("format", "pt2")
        return Exporter(get_cfg(None, self._args(kwargs, "export")))(self.model)

    def benchmark(self, **kwargs):
        """`utils.benchmarks.benchmark` over this facade."""
        from ..utils.benchmarks import benchmark
        return benchmark(self, **kwargs)

    def track(self, source=None, **kwargs):
        raise NotImplementedError("tracking is not ported yet (ROADMAP queue 1, item 9)")

    def tune(self, data: str = "synthetic", space: Optional[Dict] = None,
             grace_period: int = 10, max_samples: int = 10,
             train_args: Optional[Dict] = None, **kwargs):
        """Hyperparameter search: `utils.tuner.run_ray_tune`, the built-in
        seeded random search where ray does not import. Each trial trains
        this model in place (`train`, run directory `tune_<t>`)."""
        from ..utils.tuner import run_ray_tune
        return run_ray_tune(self, data=data, space=space, grace_period=grace_period,
                            max_samples=max_samples, train_args=train_args, **kwargs)

    # ---- info ------------------------------------------------------------
    @property
    def names(self) -> Dict[int, str]:
        return self.model.names

    def info(self):
        """(layers, parameters) of the model, logged as JAX's `info` logs them."""
        n_params = sum(p.numel() for p in self.model.parameters())
        LOGGER.info(f"model: {len(self.model.specs)} layers, {n_params:,} parameters")
        return len(self.model.specs), n_params

    def load(self, weights) -> "YOLO":
        """Warm-start from another model source: every parameter whose name
        and shape match is copied, the rest (and the BatchNorm statistics)
        kept, as JAX's non-strict `load` merges its `params`."""
        other = YOLO(weights, task=self.task, device=self.device)
        theirs = dict(other.model.named_parameters())
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if name in theirs and theirs[name].shape == p.shape:
                    p.copy_(theirs[name])
        self.predictor = None
        return self
