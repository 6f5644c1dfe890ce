"""AutoBackend: one `forward` over a live model and the port's exported
artifacts, the counterpart of the JAX package's `mgdt_yolo_tpu/nn/autobackend.py`.

Sources: a live port model; a `.pt2` program (`engine/exporter.py`),
whose `mgdt::deform_fwd` the model code registers on import, moved to the
backend's device where it was traced on another; an `.npz` weight archive
with its `<stem>_metadata.json`, rebuilt as the config it names and pinned
to the deform semantics it records (`load_npz_model`). Anything else raises
ValueError. `forward(img)` takes an NHWC float batch in [0, 1] (numpy or a
tensor) and returns the decoded (B, 4+nc, A) tensor on the backend's device
((B, 4+nc+nm, A) or (B, 4+nc+nk, A) for a segment or pose model, whose
head the npz's config names, as JAX's `DetectionModel(model_yaml)` builds
it; the (B, nc) probabilities for a classify model, which the port
rebuilds as a `ClassificationModel`, where JAX's npz leg builds every
config as a detection model).
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..device import names_device, resolve_device
from ..weights import read_metadata
from .tasks import BaseModel, model_class

LOGGER = logging.getLogger(__name__)


def load_npz_model(path, device=None):
    """(the model an npz archive holds, its metadata), through `from_npz` of
    the class its config implies (`nn.tasks.model_class`): the config and
    `nc` that `<stem>_metadata.json` names, pinned to its
    `deform_semantics` and named by its `names`. Raises ValueError where
    there is no metadata naming the config, as JAX's does."""
    meta = read_metadata(path)
    if not meta.get("model_yaml"):
        raise ValueError(f"an npz model needs the exporter's *_metadata.json (with "
                         f"model_yaml) beside {path}")
    return model_class(meta["model_yaml"]).from_npz(path, device=device), meta


def _program_device(program) -> torch.device:
    """The device an exported program's weights lie on."""
    for t in list(program.state_dict.values()) + list(program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


class AutoBackend:
    """`AutoBackend(source, imgsz=640, device=None)`: `source` a port
    model (run on its own device), or the path of a `.pt2` or
    `.npz` (run on `device`, by default CUDA)."""

    def __init__(self, model, imgsz: int = 640, device=None):
        self.imgsz = imgsz
        self.kind = "torch"
        if not isinstance(model, BaseModel):
            p = Path(str(model))
            if not p.is_file() or p.suffix not in (".npz", ".pt2"):
                raise ValueError(f"unsupported backend source: {model!r} (a model, "
                                 f"a .pt2 program or an .npz archive)")
            self.kind = p.suffix[1:]
            if self.kind == "npz":
                model = load_npz_model(p, device)[0]
        if isinstance(model, BaseModel):
            self.model = model.eval()
            self.device, self.stride, self.names = model.device, model.stride, model.names
            self._fn = model if model.task == "classify" else (lambda x: model(x)[0])
        else:
            self.device = resolve_device(device)
            program = torch.export.load(str(p))
            if not names_device(self.device, _program_device(program)):
                from torch.export.passes import move_to_device_pass
                program = move_to_device_pass(program, self.device)
            self.program, self._fn = program, program.module()
            meta = read_metadata(p)
            self.stride = tuple(meta.get("stride", [32]))
            self.names = {int(k): v for k, v in meta.get("names", {}).items()}
        LOGGER.info(f"AutoBackend: {self.kind} backend on {self.device}")

    @torch.no_grad()
    def forward(self, img) -> torch.Tensor:
        """(B, H, W, 3) float in [0, 1] -> decoded (B, 4+nc, A) on the device."""
        x = img if torch.is_tensor(img) else torch.from_numpy(np.ascontiguousarray(img))
        return self._fn(x.to(self.device, torch.float32))

    __call__ = forward

    def warmup(self, batch: int = 1):
        self.forward(torch.zeros((batch, self.imgsz, self.imgsz, 3), device=self.device))
        return self
