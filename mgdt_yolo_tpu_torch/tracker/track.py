"""The trackers on the predictor's callback bus, the counterpart of the JAX
package's `mgdt_yolo_tpu/tracker/track.py`.

`register_tracker(predictor, persist)` adds two callbacks:

* `on_predict_start`: reads the tracker YAML of `predictor.args.tracker`
  (a path, a bundled name such as `botsort.yaml`, or a bare type such as
  `bytetrack`) with the port's YAML reader, and makes the table of
  trackers, one per stream (kept across calls with `persist`).
* `on_predict_postprocess_end`: feeds each `Results` of the batch, in
  order, to its stream's tracker and replaces its boxes by the tracker's
  rows [x1, y1, x2, y2, track_id, conf, cls], the boxes the Kalman
  posterior's. The stream key is the source item's `path` for an item
  with `is_video`, and `"__frames__"` otherwise: images and the frames of
  a list or folder are one sequence, so a batch of consecutive frames
  reaches one tracker in frame order.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np

from ..utils import IterableSimpleNamespace
from ..utils.dataset_yaml import yaml_load
from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}
FRAMES_KEY = "__frames__"


def check_tracker_yaml(tracker) -> Path:
    """The tracker YAML of `tracker`: a path to a YAML, a bundled name
    (`botsort.yaml`) or a bare type (`bytetrack`); `botsort.yaml` when None."""
    name = str(tracker or "botsort.yaml")
    if not name.endswith((".yaml", ".yml")):
        name += ".yaml"
    p = Path(name)
    if not p.is_file():
        bundled = Path(__file__).parent / "cfg" / p.name
        if not bundled.is_file():
            raise FileNotFoundError(f"tracker config {name!r} not found (looked at {p} and the "
                                    f"bundled {bundled.parent})")
        p = bundled
    return p


def load_tracker_cfg(tracker) -> IterableSimpleNamespace:
    cfg = IterableSimpleNamespace(**yaml_load(check_tracker_yaml(tracker)))
    if cfg.tracker_type not in TRACKER_MAP:
        raise ValueError(f"unknown tracker_type {cfg.tracker_type!r}; "
                         f"choose from {list(TRACKER_MAP)}")
    return cfg


def on_predict_start(predictor, persist: bool = False):
    """Read the tracker's configuration and start an empty table of trackers
    (kept as it is with `persist` once there is one)."""
    if hasattr(predictor, "trackers") and persist:
        return
    predictor._tracker_cfg = load_tracker_cfg(getattr(predictor.args, "tracker", None))
    predictor.trackers = {}  # stream key -> tracker


def tracker_for(predictor, key):
    """The tracker of stream `key`, made at its first frame."""
    tr = predictor.trackers.get(key)
    if tr is None:
        cfg = predictor._tracker_cfg
        tr = TRACKER_MAP[cfg.tracker_type](args=cfg, frame_rate=30)
        predictor.trackers[key] = tr
    return tr


def _stream_key(predictor, i) -> str:
    items = getattr(predictor, "batch_items", None)
    if items is not None and i < len(items) and items[i].get("is_video"):
        return items[i].get("path", FRAMES_KEY)
    return FRAMES_KEY


def _host(x) -> np.ndarray:
    """`x` as a numpy array on the host (a tensor is copied off its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def on_predict_postprocess_end(predictor):
    """Update each result's stream tracker with its detections, in order,
    and put the tracks in the result's boxes."""
    for i, result in enumerate(predictor.results):
        tracker = tracker_for(predictor, _stream_key(predictor, i))
        det = _host(result.boxes.data) if result.boxes is not None else np.zeros((0, 6))
        if len(det) == 0:
            tracker.update(np.zeros((0, 4), np.float32), np.zeros((0,)), np.zeros((0,)),
                           result.orig_img)
            continue
        tracks = tracker.update(det[:, :4], det[:, 4], det[:, 5], result.orig_img)
        # the rows' eighth column (the detection's row) is dropped
        result.update(boxes=tracks[:, :7].astype(np.float32) if len(tracks)
                      else np.zeros((0, 7), np.float32))


def register_tracker(predictor, persist: bool = False):
    predictor.add_callback("on_predict_start", partial(on_predict_start, persist=persist))
    predictor.add_callback("on_predict_postprocess_end", on_predict_postprocess_end)
