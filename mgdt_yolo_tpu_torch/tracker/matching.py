"""Association costs and the assignment of the trackers, the counterpart of
the JAX package's `mgdt_yolo_tpu/tracker/matching.py`.

`linear_assignment` solves with scipy's `linear_sum_assignment` after
replacing every cost above the threshold by `thresh + 1e4`, then drops the
pairs above the threshold, as JAX does.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.optimize

from ..utils.metrics import box_iou_numpy


def linear_assignment(cost: np.ndarray, thresh: float
                      ) -> Tuple[np.ndarray, List[int], List[int]]:
    """(matches (k, 2) [row, col], unmatched rows, unmatched columns) of
    the least-cost assignment with no pair above `thresh`."""
    if cost.size == 0:
        return (np.empty((0, 2), int), list(range(cost.shape[0])),
                list(range(cost.shape[1])))
    c = np.where(cost > thresh, thresh + 1e4, cost)
    rows, cols = scipy.optimize.linear_sum_assignment(c)
    matches = [(r, co) for r, co in zip(rows, cols) if cost[r, co] <= thresh]
    matched_r = {r for r, _ in matches}
    matched_c = {co for _, co in matches}
    unmatched_r = [r for r in range(cost.shape[0]) if r not in matched_r]
    unmatched_c = [co for co in range(cost.shape[1]) if co not in matched_c]
    return np.asarray(matches, int).reshape(-1, 2), unmatched_r, unmatched_c


def iou_distance(atracks, btracks) -> np.ndarray:
    """1 - IoU of the tracks' `tlbr` boxes, (len(a), len(b)) float32."""
    a = np.asarray([t.tlbr for t in atracks], np.float32).reshape(-1, 4)
    b = np.asarray([t.tlbr for t in btracks], np.float32).reshape(-1, 4)
    if len(a) == 0 or len(b) == 0:
        return np.ones((len(a), len(b)), np.float32)
    return 1.0 - box_iou_numpy(a, b)


def embedding_distance(tracks, detections, metric: str = "cosine") -> np.ndarray:
    """Appearance cost of the tracks' smoothed features against the
    detections' features: cosine (clipped at 0) or Euclidean."""
    cost = np.zeros((len(tracks), len(detections)), np.float32)
    if cost.size == 0:
        return cost
    det = np.asarray([d.curr_feat for d in detections], np.float32)
    trk = np.asarray([t.smooth_feat for t in tracks], np.float32)
    if metric == "cosine":
        det = det / (np.linalg.norm(det, axis=1, keepdims=True) + 1e-12)
        trk = trk / (np.linalg.norm(trk, axis=1, keepdims=True) + 1e-12)
        return np.maximum(0.0, 1.0 - trk @ det.T)
    for i, t in enumerate(trk):
        cost[i] = np.linalg.norm(det - t, axis=1)
    return cost


def fuse_score(cost: np.ndarray, detections) -> np.ndarray:
    """The IoU cost with each detection's score folded in: 1 - (1 - cost) * score."""
    if cost.size == 0:
        return cost
    scores = np.asarray([d.score for d in detections])[None].repeat(cost.shape[0], 0)
    return 1.0 - (1.0 - cost) * scores
