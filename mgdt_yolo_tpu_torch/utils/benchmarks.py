"""Benchmark of the runtime backends: the counterpart of the JAX package's
`mgdt_yolo_tpu/utils/benchmarks.py`, over the port's formats.

`benchmark(yolo, formats=["torch", "pt2", "npz"], ...)` times each
backend's forward (`nn/autobackend.AutoBackend`: the live module, the
exported `.pt2` program, the model rebuilt from the exported `.npz`) on the
facade's device over seeded noise at `batch` x `imgsz`, with a synchronise
before each clock read on the card, and, where `data` is given, validates
the backend's mAP50 on that dataset's `val` split through the validator
with the backend's forward in place of the model's.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)


class _BackendModel(torch.nn.Module):
    """A backend dressed as the validator's model: its forward returns
    (decoded, None), with the facade model's device, nc and names."""

    def __init__(self, backend, model):
        super().__init__()
        self.backend, self.nc, self.names = backend, model.nc, model.names
        self.stride, self._device = model.stride, model.device

    @property
    def device(self) -> torch.device:
        return self._device

    def forward(self, x):
        return self.backend(x), None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(model, imgsz: int = 640, formats: Optional[List[str]] = None,
              n_iters: int = 10, batch: int = 1, hard_fail: bool = False,
              data: Optional[str] = None) -> List[Dict]:
    """Rows {format, ok, images_per_sec, ms_per_image, map50} for each
    format, timed over `n_iters` forwards after a warm-up one (the fastest
    and slowest dropped). `model` is a `YOLO` facade. A failing format is
    logged and given `ok` False, or raises with `hard_fail`; `data` (a
    dataset YAML or directory) validates each backend on its whole `val`
    split.
    """
    from ..engine.validator import DetectionValidator
    from ..nn.autobackend import AutoBackend
    formats = formats or ["torch", "pt2"]
    dev = model.model.device
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (batch, imgsz, imgsz, 3)).astype(np.float32)).to(dev)
    rows = []
    for fmt in formats:
        ok, ips, map50 = False, 0.0, None
        try:
            if fmt == "torch":
                backend = AutoBackend(model.model, imgsz)
            elif fmt in ("pt2", "npz"):
                out = model.export(format=fmt, imgsz=imgsz)
                backend = AutoBackend(out[0], imgsz, device=dev)
            else:
                raise ValueError(f"unknown benchmark format {fmt!r}")
            backend.forward(x)
            times = []
            for _ in range(n_iters):
                _sync(dev)
                t0 = time.perf_counter()
                backend.forward(x)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            times = sorted(times)[1:-1] or times
            ips = batch / (sum(times) / len(times))
            if data is not None:
                res = DetectionValidator({"data": data, "imgsz": imgsz, "batch": batch})(
                    _BackendModel(backend, model.model))
                map50 = float(res["map50"])
            ok = True
        except Exception as e:  # a format that fails is a row of the table, not the end
            LOGGER.warning(f"benchmark {fmt} failed: {e!r}")
            if hard_fail:
                raise
        rows.append({"format": fmt, "ok": ok, "images_per_sec": ips,
                     "ms_per_image": 1000.0 / ips if ips else None, "map50": map50})
    for r in rows:
        LOGGER.info(str(r))
    return rows
