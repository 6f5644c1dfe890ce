"""BoT-SORT, the counterpart of the JAX package's
`mgdt_yolo_tpu/tracker/bot_sort.py`: ByteTrack's association over an XYWH
Kalman state, with the camera's motion compensated (`gmc.GMC`) on every
frame and the optional appearance cost.

The GMC runs on every frame given an image and warps both the tracked
and the lost pool. `with_reid` keeps JAX's slot: `encoder` is None and
nothing builds one, so the appearance branch of `get_dists` never runs
until a caller sets an encoder (with an `inference(img, dets)` method).
"""
from __future__ import annotations

from collections import deque
from types import SimpleNamespace
from typing import List

import numpy as np

from .byte_tracker import BYTETracker, STrack, xyxy_to_tlwh
from .gmc import GMC
from .kalman import KalmanFilterXYWH
from .matching import embedding_distance, fuse_score, iou_distance


class BOTrack(STrack):
    """A track with an XYWH state and a smoothed appearance feature."""

    shared_kalman = KalmanFilterXYWH()
    _frozen = (6, 7)

    def __init__(self, tlwh, score, cls, feat=None, feat_history: int = 50):
        super().__init__(tlwh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        self.features = deque(maxlen=feat_history)
        self.alpha = 0.9
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat):
        feat = feat / (np.linalg.norm(feat) + 1e-12)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else \
            self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.features.append(feat)
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-12

    def convert_coords(self, tlwh):
        return self.tlwh_to_xywh(tlwh)

    @staticmethod
    def tlwh_to_xywh(tlwh):
        x = np.asarray(tlwh, np.float32).copy()
        x[:2] += x[2:] / 2
        return x

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        x = self.mean[:4].copy()  # cx, cy, w, h
        x[:2] -= x[2:] / 2
        return x

    @staticmethod
    def multi_gmc(tracks: List["BOTrack"], H: np.ndarray):
        """Move each track's state by the camera's motion H (2, 3): the
        2 x 2 part on each (x, y) pair of the state, the translation on the
        centre."""
        if not tracks or H is None:
            return
        R8 = np.kron(np.eye(4), H[:2, :2])
        t = H[:2, 2]
        for trk in tracks:
            mean = R8 @ trk.mean
            mean[:2] += t
            trk.mean = mean
            trk.covariance = R8 @ trk.covariance @ R8.T


class BOTSORT(BYTETracker):
    """BoT-SORT; `update(boxes, scores, cls, img)` as `BYTETracker.update`,
    with the camera's motion estimated from `img` (BGR uint8)."""

    def __init__(self, args=None, frame_rate: int = 30):
        args = args or SimpleNamespace(
            track_high_thresh=0.5, track_low_thresh=0.1, new_track_thresh=0.6,
            track_buffer=30, match_thresh=0.8, gmc_method="sparseOptFlow",
            proximity_thresh=0.5, appearance_thresh=0.25, with_reid=False)
        super().__init__(args, frame_rate)
        self.proximity_thresh = args.proximity_thresh
        self.appearance_thresh = args.appearance_thresh
        self.with_reid = getattr(args, "with_reid", False)
        self.encoder = None  # the appearance model's slot
        self.gmc = GMC(method=getattr(args, "gmc_method", "sparseOptFlow"))

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def init_track(self, dets, scores, cls, img=None):
        if len(dets) == 0:
            return []
        if self.with_reid and self.encoder is not None:
            feats = self.encoder.inference(img, dets)
            return [BOTrack(xyxy_to_tlwh(d), s, c, f)
                    for d, s, c, f in zip(dets, scores, cls, feats)]
        return [BOTrack(xyxy_to_tlwh(d), s, c) for d, s, c in zip(dets, scores, cls)]

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        dists_mask = dists > self.proximity_thresh
        dists = fuse_score(dists, detections)
        if self.with_reid and self.encoder is not None and len(tracks) and len(detections):
            emb = embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists

    def multi_predict(self, tracks):
        BOTrack.multi_predict(tracks)

    def update(self, boxes, scores, cls, img=None):
        if img is not None:
            H = self.gmc.apply(img)
            BOTrack.multi_gmc(self.tracked_stracks, H)
            BOTrack.multi_gmc(self.lost_stracks, H)
        return super().update(boxes, scores, cls, img)
