"""The `RTDETR` facade, the counterpart of `mgdt_yolo_tpu/vit/rtdetr/model.py`.

`RTDETR(model="yolov8-rtdetr.yaml", task="detect", device=None)` builds an
`RTDETRDetectionModel` from a config's YAML file name (`rtdetr-l.yaml`,
`rtdetr-x.yaml`, `yolov8n-rtdetr.yaml` ...; the port's seeded init),
loads an `.npz` with its `<stem>_metadata.json` (an `RTDETRTrainer`
checkpoint) or a reference `.pt` (`RTDETRDetectionModel.from_pt`, the file
kept as `ckpt`), on `device` (CUDA by default). A `.pt` is the file JAX's
`YOLO(pt)` builds into its `DetectionModel`; the port's `YOLO` refuses it,
and `RTDETR` serves it. `predict(source, **kwargs)`
runs an `RTDETRPredictor` over a folded copy of the model, rebuilt when
keywords are given; `batch=` sets the images a forward (1 by default).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

from ...cfg.default import CFG_DEFAULTS
from ...device import parse_device
from ...nn.tasks import RTDETRDetectionModel
from .predict import RTDETRPredictor


class RTDETR:
    """See the module's text."""

    def __init__(self, model: str = "yolov8-rtdetr.yaml", task: str = "detect", device=None):
        self.task = task
        self.device = parse_device(device)
        self.predictor: Optional[RTDETRPredictor] = None
        self.ckpt = None
        model = str(model)
        if model.endswith(".npz"):
            self.model = RTDETRDetectionModel.from_npz(model, device=self.device)
        elif model.endswith(".pt"):
            self.model, pt = RTDETRDetectionModel.from_pt(model, device=self.device)
            self.ckpt = pt.ckpt
        else:
            self.model = RTDETRDetectionModel(model, device=self.device)
        self.overrides = {"model": model, "task": task}

    def predict(self, source, stream: bool = False, **kwargs):
        batch = int(kwargs.pop("batch", 1))
        args = {k: v for k, v in {**self.overrides, **kwargs, "mode": "predict"}.items()
                if k in CFG_DEFAULTS and k not in ("model", "task", "mode")}
        args.setdefault("device", str(self.device))
        if self.predictor is None or kwargs:
            self.predictor = RTDETRPredictor(args).setup_model(copy.deepcopy(self.model))
        return self.predictor(source, stream=stream, batch=batch)

    def __call__(self, source, **kwargs):
        return self.predict(source, **kwargs)

    @property
    def names(self) -> Dict[int, str]:
        return self.model.names

    def info(self):
        """(layers, parameters) of the model."""
        return len(self.model.specs), sum(p.numel() for p in self.model.parameters())
