"""A micro-batching inference server for concurrent single-image requests.

The counterpart of the JAX package's `mgdt_yolo_tpu/engine/serve.py`, with
the same public surface and semantics:

- **micro-batching**: requests that arrive within `max_wait_ms` of the
  first of a batch are coalesced, up to `batch`, into one forward + NMS,
  padded with zero images to `batch` so every step has one shape;
- **overlap**: a collector thread letterboxes and dispatches batch i + 1
  while the device computes batch i, and a drainer thread resolves the
  requests of the oldest batch in flight; at most two batches are in
  flight, so a request waits behind at most one foreign batch.

Where JAX overlaps through its asynchronous dispatch, here each batch goes
on the server's own CUDA stream: the uint8 batch is uploaded from pinned
memory, the detections come back into pinned memory, and an event recorded
after that copy is what the drainer waits on, never the whole device (a
`torch.cuda.synchronize()` there would also wait for the next batch).

Usage::

    server = serve(model, batch=8, max_wait_ms=2.0)   # model on the card
    fut = server.submit(bgr_image)                     # a concurrent Future
    result = fut.result()                              # engine.results.Results
    server.stop()

The model is served as it is given (fold and cast it first for speed). The
server's device is CUDA unless `device` names another, and must be the
model's; without a CUDA device the default raises (`device.resolve_device`).
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import names_device, resolve_device
from .predictor import det_to_original, infer, letterbox_batch
from .results import Results

LOGGER = logging.getLogger(__name__)


def _safe_resolve(fut: Future, result=None, exc: Optional[Exception] = None):
    """Resolve a request's future without ever raising: a caller may cancel a
    pending future, and setting a cancelled one raises InvalidStateError,
    which must not kill a worker loop."""
    try:
        if fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:
        pass  # cancelled between the done() check and the set


class _Ready:
    """The CPU's stand-in for a CUDA event: its work is done at dispatch."""

    def synchronize(self):
        pass


class InferenceServer:
    """Coalesce concurrent single-image requests into micro-batches.

    Two worker threads: a collector that gathers up to `batch` requests
    (waiting at most `max_wait_ms` after the first for stragglers),
    letterboxes them into one padded batch and dispatches it; and a drainer
    that waits for the oldest batch in flight and resolves its futures. One
    failed batch fails its own requests' futures, one failed request its
    own, and the server goes on.
    """

    def __init__(self, model, batch: int = 8, max_wait_ms: float = 2.0, imgsz: int = 640,
                 conf: float = 0.25, iou: float = 0.7, max_det: int = 300,
                 agnostic: bool = False, device=None):
        self.device = resolve_device(device)
        if not names_device(self.device, model.device):
            raise ValueError(f"the model is on {model.device}, the server's device is "
                             f"{self.device}")
        self.model = model.eval()
        self.batch = int(batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.imgsz = int(imgsz)
        self.names = getattr(model, "names", {})
        self._nms = dict(conf=conf, iou=iou, max_det=max_det, agnostic=agnostic)
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._requests: "queue.SimpleQueue" = queue.SimpleQueue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = object()  # sentinel
        self._started = False
        self._lock = threading.Lock()
        self.stats: Dict[str, float] = {"requests": 0, "batches": 0, "occupancy_sum": 0}
        self._latencies: List[float] = []

    # ---- public surface ----------------------------------------------------
    def start(self) -> "InferenceServer":
        if self._started:
            return self
        self._started = True
        self._collector = threading.Thread(target=self._collect_loop,
                                           name="mgdt-serve-collect", daemon=True)
        self._drainer = threading.Thread(target=self._drain_loop,
                                         name="mgdt-serve-drain", daemon=True)
        self._collector.start()
        self._drainer.start()
        return self

    def submit(self, img_bgr: np.ndarray) -> Future:
        """Enqueue one BGR HWC uint8 image; resolves to a Results object."""
        # check and put under the lock stop() takes to flip _started, so no
        # request lands in a queue that no worker reads any more
        with self._lock:
            if not self._started:
                raise RuntimeError("InferenceServer not started (call .start())")
            fut: Future = Future()
            self._requests.put((img_bgr, fut, time.monotonic()))
        return fut

    def predict(self, img_bgr: np.ndarray) -> Results:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(img_bgr).result()

    def stop(self):
        """Drain the work in flight and join the worker threads."""
        with self._lock:
            if not self._started:
                return
            self._started = False  # new submit() calls fail from here on
        self._requests.put(self._stop)
        self._collector.join()
        # fail any request that was queued behind the sentinel
        while True:
            try:
                item = self._requests.get_nowait()
            except queue.Empty:
                break
            if item is self._stop:
                continue
            _safe_resolve(item[1], exc=RuntimeError("InferenceServer stopped"))
        self._inflight.put(self._stop)
        self._drainer.join()

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def latency_ms(self) -> Dict[str, float]:
        """Submit-to-result latency percentiles of the served requests."""
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64) * 1e3
        if lat.size == 0:
            return {"n": 0}
        return {"n": int(lat.size), "mean": float(lat.mean()),
                "p50": float(np.percentile(lat, 50)), "p90": float(np.percentile(lat, 90)),
                "max": float(lat.max())}

    @property
    def mean_occupancy(self) -> float:
        b = self.stats["batches"]
        return self.stats["occupancy_sum"] / b if b else 0.0

    # ---- worker loops --------------------------------------------------------
    def _collect_loop(self):
        while True:
            item = self._requests.get()
            if item is self._stop:
                return
            reqs = [item]
            deadline = time.monotonic() + self.max_wait_s
            while len(reqs) < self.batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._requests.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._stop:
                    self._dispatch(reqs)
                    return
                reqs.append(nxt)
            self._dispatch(reqs)

    def _dispatch(self, reqs):
        try:
            self._dispatch_inner(reqs)
        except Exception as e:  # fail the batch, keep the server alive
            LOGGER.warning(f"serve: batch dispatch failed: {e}")
            for _img, fut, _t in reqs:
                _safe_resolve(fut, exc=e)

    @torch.no_grad()
    def _dispatch_inner(self, reqs):
        x, metas = letterbox_batch([img for img, _fut, _t in reqs], self.imgsz)
        if len(reqs) < self.batch:  # pad to the one batch shape
            x = np.concatenate([x, np.zeros((self.batch - len(reqs), *x.shape[1:]), x.dtype)])
        x = torch.from_numpy(x)
        cuda = self._stream is not None
        with torch.cuda.stream(self._stream) if cuda else contextlib.nullcontext():
            if cuda:
                x = x.pin_memory()
            det, counts = infer(self.model, x.to(self.device, non_blocking=True), **self._nms)
            det = det.float()
            out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda) for t in (det, counts)]
            for host, t in zip(out, (det, counts)):
                host.copy_(t, non_blocking=True)
            done = torch.cuda.Event() if cuda else _Ready()
            if cuda:
                done.record(self._stream)
        self.stats["batches"] += 1
        self.stats["requests"] += len(reqs)
        self.stats["occupancy_sum"] += len(reqs)
        # the device tensors and the pinned input stay referenced until drained
        self._inflight.put((reqs, metas, out, done, (x, det, counts)))  # blocks at depth 2

    def _drain_loop(self):
        while True:
            item = self._inflight.get()
            if item is self._stop:
                return
            reqs, metas, (dets, counts), done, _keep = item
            try:
                done.synchronize()
                dets, counts = dets.numpy(), counts.numpy()
            except Exception as e:  # resolve futures instead of hanging callers
                for _img, fut, _t in reqs:
                    _safe_resolve(fut, exc=e)
                continue
            t_done = time.monotonic()
            for j, (img, fut, t_sub) in enumerate(reqs):
                try:
                    det = det_to_original(dets[j][:int(counts[j])].copy(), self.imgsz, metas[j])
                    lat = t_done - t_sub
                    with self._lock:
                        self._latencies.append(lat)
                        if len(self._latencies) > 10000:
                            del self._latencies[:5000]
                    speed = {"preprocess": 0.0, "inference": lat * 1e3, "postprocess": 0.0}
                    _safe_resolve(fut, Results(img, "", self.names, det, speed=speed))
                except Exception as e:  # one bad request must not kill the drainer
                    _safe_resolve(fut, exc=e)
                    LOGGER.warning(f"serve: request postprocess failed: {e}")


def serve(model, **kwargs) -> InferenceServer:
    """Build and start an InferenceServer on a model."""
    return InferenceServer(model, **kwargs).start()
