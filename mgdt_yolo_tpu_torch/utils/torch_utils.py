"""Model introspection, timing and seeding: the counterparts of the JAX
package's `utils/torch_utils.py:19-157`.

* `Profile` times a block on the host's clock, synchronising the card
  around it where its device is CUDA.
* `get_flops` counts a forward's GFLOPs with
  `torch.utils.flop_counter.FlopCounterMode` over the raw-map
  (training-mode) forward, as JAX counts its `train=True` forward with
  XLA's cost analysis. The mode counts the products of convolutions and
  matrix products; XLA counts the elementwise work too, so JAX's figure is
  larger by design. The DCN is the operator `mgdt::deform_fwd`, which the
  mode cannot see into: its formula, registered here, is the DCN's
  product, 2 B Ho Wo 9 Cin Cout (a 3x3 conv of the same widths), without
  the bilinear sampling, so the count is the same whether K1 or the plain
  version runs inside the operator. A DCN of another shape runs the plain
  exact path, whose contraction the mode counts by the same formula.
* `model_info` gives JAX's layers, parameters and GFLOPs.
* `profile_layers` times each prefix of the graph and returns the
  per-layer differences, as JAX's; on CUDA by events.
* `start_trace` / `stop_trace` record `torch.profiler` and write a Chrome
  trace, where JAX writes an xprof trace.
* `init_seeds` seeds `random`, numpy and torch and returns a seeded
  `torch.Generator` (JAX's returns a PRNG key); `random` and numpy draw
  what they draw after JAX's call.
* `strip_optimizer` writes `<stem>_stripped.npz`: a checkpoint's EMA
  weights as float16 and its batch statistics, with its metadata, and
  without the `<stem>_resume.npz` training state (npz, where JAX's writes
  an orbax directory).
"""
from __future__ import annotations

import copy
import json
import logging
import math
import os
import random
import tempfile
import time
from contextlib import ContextDecorator
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ..ops import cuda_deform  # noqa: F401  (defines the mgdt::deform_fwd operator)

LOGGER = logging.getLogger(__name__)
_TRACE: Dict[str, object] = {}


@register_flop_formula(torch.ops.mgdt.deform_fwd)
def _deform_fwd_flops(x_shape, offset_shape, mask_shape, weight_shape, *args,
                      out_shape=None, **kwargs) -> int:
    """The DCN's product: 2 B Ho Wo kh kw Cin Cout (no sampling work)."""
    kh, kw, cin, cout = weight_shape
    return 2 * out_shape[0] * out_shape[1] * out_shape[2] * kh * kw * cin * cout


class Profile(ContextDecorator):
    """Seconds of a block on the host's clock (`dt`; `t` sums them), as
    JAX's `Profile`: `with Profile(device) as p: ...`. Where `device` (or
    the device of the tensor `sync`) is CUDA, the card is synchronised when
    the block starts and when it ends, so the time covers its device work."""

    def __init__(self, device=None, sync: Optional[torch.Tensor] = None):
        self.t = 0.0
        self.dt = 0.0
        dev = sync.device if torch.is_tensor(sync) else (
            None if device is None else torch.device(device))
        self.device = dev if dev is not None and dev.type == "cuda" else None

    def _time(self) -> float:
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __enter__(self):
        self.start = self._time()
        return self

    def __exit__(self, *exc):
        self.dt = self._time() - self.start
        self.t += self.dt
        return False


def _param_dtype(model) -> torch.dtype:
    return next(model.parameters()).dtype


def get_flops(model, imgsz: int = 640) -> float:
    """GFLOPs of one (1, imgsz, imgsz, 3) raw-map forward (the model in
    training mode, BatchNorm on batch statistics) on the model's device, as
    `FlopCounterMode` counts them (see the module's text). The model itself
    is left as it was: a copy runs."""
    m = copy.deepcopy(model).train()
    x = torch.zeros((1, imgsz, imgsz, 3), dtype=_param_dtype(model),
                    device=next(model.parameters()).device)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        m(x)
    return counter.get_total_flops() / 1e9


def model_info(model, imgsz: int = 640, verbose: bool = True) -> Dict:
    """{"layers": the graph's layers, "params": its parameter count (JAX's
    `params` collection), "gflops": `get_flops`}, logged where `verbose`."""
    n_layers = len(model.specs)
    n_params = sum(p.numel() for p in model.parameters())
    gflops = get_flops(model, imgsz)
    if verbose:
        LOGGER.info(f"model summary: {n_layers} layers, {n_params:,} parameters, "
                    f"{gflops:.1f} GFLOPs @ {imgsz}px")
    return {"layers": n_layers, "params": n_params, "gflops": gflops}


def profile_layers(model, imgsz: int = 256, runs: int = 10) -> List[float]:
    """Milliseconds of each layer of the graph, as the differences of the
    mean times of its prefixes (the first 1, 2, ... layers of a
    training-mode forward of a (1, imgsz, imgsz, 3) batch, `runs` calls
    after a warm-up one), as JAX's `profile_layers`; timed by CUDA events on
    the card, by the host's clock on the CPU. Each layer is logged."""
    m = copy.deepcopy(model).train()
    dev = next(model.parameters()).device
    x = torch.zeros((1, imgsz, imgsz, 3), dtype=_param_dtype(model), device=dev)
    results = []
    with torch.no_grad():
        for upto in range(1, len(m.specs) + 1):
            m._run(x, upto=upto)
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(runs):
                    m._run(x, upto=upto)
                end.record()
                torch.cuda.synchronize(dev)
                results.append(start.elapsed_time(end) / runs)
            else:
                t0 = time.perf_counter()
                for _ in range(runs):
                    m._run(x, upto=upto)
                results.append((time.perf_counter() - t0) / runs * 1e3)
    deltas = [results[0]] + [results[i] - results[i - 1] for i in range(1, len(results))]
    for spec, d in zip(m.specs, deltas):
        LOGGER.info(f"{spec.i:>3} {spec.name:<28} {d:8.3f} ms")
    return deltas


def start_trace(log_dir=None) -> str:
    """Start recording `torch.profiler` (the host, and the card where CUDA
    is available); `stop_trace` writes the Chrome trace under `log_dir`
    (by default `mgdt_trace` in the temporary directory). Returns
    `log_dir`."""
    if "profiler" in _TRACE:
        raise RuntimeError("a trace is already being recorded: call stop_trace first")
    log_dir = str(log_dir or Path(tempfile.gettempdir()) / "mgdt_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _TRACE.update(profiler=prof, log_dir=log_dir)
    return log_dir


def stop_trace() -> str:
    """Stop the recording `start_trace` began and write it as a Chrome
    trace, `<log_dir>/trace_<pid>_<ns>.json`; returns that file's path."""
    if "profiler" not in _TRACE:
        raise RuntimeError("no trace is being recorded: call start_trace first")
    prof, log_dir = _TRACE.pop("profiler"), _TRACE.pop("log_dir")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    path = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    return str(path)


def init_seeds(seed: int = 0, deterministic: bool = True) -> torch.Generator:
    """Seed `random`, numpy and torch with `seed`, and return a CPU
    `torch.Generator` seeded with it. `deterministic` is taken and unused,
    as in JAX."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100):
    """The cosine ramp from y1 to y2 over `steps`."""
    def fn(x):
        return ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1
    return fn


def strip_optimizer(npz, out=None) -> str:
    """Write a deployable copy of the checkpoint `npz` (a trainer's
    `last.npz` or `best.npz`, which hold the EMA weights and the batch
    statistics): its parameters as float16, its statistics as they are, its
    metadata with `"stripped": true` (the deform pin and the config kept),
    and nothing of its `<stem>_resume.npz` training state. `out` defaults to
    `<stem>_stripped.npz` beside it. Returns the written path."""
    from ..weights import read_metadata
    src = Path(npz)
    dst = Path(out) if out else src.with_name(f"{src.stem}_stripped.npz")
    with np.load(str(src)) as f:
        arrays = {k: (f[k].astype(np.float16) if k.startswith("params.") else f[k])
                  for k in f.files}
    dst.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(dst), **arrays)
    meta = {**read_metadata(src), "stripped": True}
    (dst.parent / f"{dst.stem}_metadata.json").write_text(json.dumps(meta, indent=1))
    return str(dst)
