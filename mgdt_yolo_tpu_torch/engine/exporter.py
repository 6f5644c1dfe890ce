"""Model export: the counterpart of the JAX package's
`mgdt_yolo_tpu/engine/exporter.py`, with the port's own artifact.

* `pt2`: `torch.export` of the float32, unfused eval forward with the decode
  included, input (B, imgsz, imgsz, 3) NHWC float in [0, 1] with the batch
  dimension dynamic (JAX's symbolic `b`), output the decoded (B, 4+nc, A),
  saved with `torch.export.save`. It is the port's counterpart of JAX's
  `stablehlo` artifact. The DCN is the registered operator
  `mgdt::deform_fwd` (`ops/cuda_deform.py`), one node of the program, so
  the program launches K1 on the card; it is traced on the model's device.
* `npz`: the flat flax-keyed weight archive the JAX package reads
  (`weights.save_npz`).

Each export writes `<stem>_metadata.json` beside the artifact with JAX's
keys (imgsz, nc, stride, names, model_yaml, deform_semantics, layout,
output) and the task. `stablehlo` raises naming `pt2`; `saved_model` and
`tflite` need TensorFlow, which the port does not use (ROADMAP queue 1,
item 14).
"""
from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path
from typing import List, Optional

import torch
import torch.nn as nn

from ..cfg import get_cfg
from ..weights import save_npz

LOGGER = logging.getLogger(__name__)
EXPORT_FORMATS = {"pt2": ".pt2", "npz": ".npz"}
REFUSED_FORMATS = {
    "stablehlo": "format 'stablehlo' is the JAX package's XLA artifact; the port's "
                 "counterpart is format='pt2' (torch.export)",
    "saved_model": "format 'saved_model' needs TensorFlow, which the port does not use "
                   "(ROADMAP queue 1, item 14); use 'pt2' or 'npz'",
    "tflite": "format 'tflite' needs TensorFlow, which the port does not use "
              "(ROADMAP queue 1, item 14); use 'pt2' or 'npz'"}


class DecodedForward(nn.Module):
    """The eval forward's decoded output alone, the exported function."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)[0]


def metadata(model, imgsz: int) -> dict:
    """What `<stem>_metadata.json` records of `model`, JAX's keys and the task."""
    return {"imgsz": imgsz, "nc": model.nc, "stride": list(model.stride),
            "names": {str(k): str(v) for k, v in model.names.items()},
            "model_yaml": model.model_yaml or "",
            "deform_semantics": model.deform_semantics,
            "layout": "NHWC", "output": "(1, 4+nc, A) xywh+scores", "task": "detect"}


class Exporter:
    """`Exporter(args)(model, fmt=None)` -> [path of the artifact]; `args`
    (a configuration from `cfg.get_cfg`, or a dict of overrides it checks)
    give `format`, `imgsz` and `project` (the directory, by default
    `runs/export`)."""

    def __init__(self, args=None):
        self.args = args if hasattr(args, "imgsz") else get_cfg(None, args)

    def __call__(self, model, fmt: Optional[str] = None) -> List[str]:
        fmt = (fmt or self.args.format or "pt2").lower()
        if fmt in REFUSED_FORMATS:
            raise RuntimeError(REFUSED_FORMATS[fmt])
        if fmt not in EXPORT_FORMATS:
            raise ValueError(f"unknown export format {fmt!r}; available: "
                             f"{list(EXPORT_FORMATS)}")
        imgsz = int(self.args.imgsz)
        out_dir = Path(self.args.project or "runs/export")
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{Path(model.model_yaml or 'model').stem}{EXPORT_FORMATS[fmt]}"
        t0 = time.perf_counter()
        meta = metadata(model, imgsz)
        if fmt == "npz":
            save_npz(model, path, meta)
        else:
            self.export_pt2(model, imgsz, path)
            (path.parent / f"{path.stem}_metadata.json").write_text(json.dumps(meta, indent=1))
        LOGGER.info(f"export: {fmt} ({time.perf_counter() - t0:.1f} s) -> {path}")
        return [str(path)]

    @staticmethod
    def export_pt2(model, imgsz: int, path: Path) -> Path:
        """`torch.export` of a float32 copy of `model`'s eval forward, the
        batch dimension dynamic, traced on the model's device."""
        m = DecodedForward(copy.deepcopy(model).float().eval())
        x = torch.zeros((2, imgsz, imgsz, 3), device=model.device)
        # Dim.AUTO, not Dim("b", min=1): export assumes sizes >= 2 and then
        # refuses a declared range that includes 1; the program it gives
        # still runs a batch of 1, whose size its input check lets through
        with torch.no_grad():
            program = torch.export.export(m, (x,),
                                          dynamic_shapes={"x": {0: torch.export.Dim.AUTO}})
        torch.export.save(program, str(path))
        return path
