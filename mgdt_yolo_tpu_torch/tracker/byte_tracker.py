"""ByteTrack, the counterpart of the JAX package's
`mgdt_yolo_tpu/tracker/byte_tracker.py`.

Each frame, detections above `track_high_thresh` are matched first to the
Kalman-predicted pool of tracked and lost tracks by the score-fused IoU
cost; those strictly between `track_low_thresh` and `track_high_thresh`
rescue the tracks still tracked; the tracks born last frame get a last
pass; unmatched high detections of at least `new_track_thresh` start
tracks, and tracks lost longer than `track_buffer` frames (at 30 fps) are
removed.

The ID counter `STrack._count` belongs to the class, and every new
`BYTETracker` resets it, as JAX's does: a tracker made for a new stream
restarts the numbering of every stream. A track is `is_activated` at
birth only on frame 1, later from its second match on.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from .kalman import KalmanFilterXYAH
from .matching import fuse_score, iou_distance, linear_assignment


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class STrack:
    """One track: its box, score, class, Kalman state and life cycle."""

    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, tlwh, score: float, cls: int):
        self._tlwh = np.asarray(tlwh, np.float32)
        self.score = float(score)
        self.cls = int(cls)
        self.kalman_filter: Optional[KalmanFilterXYAH] = None
        self.mean = None
        self.covariance = None
        self.is_activated = False
        self.track_id = 0
        self.state = TrackState.New
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0
        self.idx = -1  # the row of the frame's detections

    @staticmethod
    def next_id() -> int:
        STrack._count += 1
        return STrack._count

    @staticmethod
    def reset_id():
        STrack._count = 0

    def activate(self, kalman_filter, frame_id: int):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self.convert_coords(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track: "STrack", frame_id: int, new_id: bool = False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.convert_coords(new_track.tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track: "STrack", frame_id: int):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.convert_coords(new_track.tlwh))
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    # the velocity component zeroed for a track not tracked (the aspect's
    # rate here, the height's in BOTrack)
    _frozen = (7,)

    def predict(self):
        mean = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean[list(self._frozen)] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean, self.covariance)

    @classmethod
    def multi_predict(cls, tracks: List["STrack"]):
        if not tracks:
            return
        means = np.stack([t.mean.copy() for t in tracks])
        covs = np.stack([t.covariance for t in tracks])
        for i, t in enumerate(tracks):
            if t.state != TrackState.Tracked:
                means[i][list(cls._frozen)] = 0
        means, covs = cls.shared_kalman.multi_predict(means, covs)
        for i, t in enumerate(tracks):
            t.mean, t.covariance = means[i], covs[i]

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    def convert_coords(self, tlwh):
        return self.tlwh_to_xyah(tlwh)

    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        x = self.mean[:4].copy()  # cx, cy, a, h
        x[2] *= x[3]
        x[:2] -= x[2:] / 2
        return x

    @property
    def tlbr(self) -> np.ndarray:
        t = self.tlwh
        return np.concatenate([t[:2], t[:2] + t[2:]])

    @staticmethod
    def tlwh_to_xyah(tlwh) -> np.ndarray:
        x = np.asarray(tlwh, np.float32).copy()
        x[:2] += x[2:] / 2
        x[2] /= x[3]
        return x

    @property
    def end_frame(self):
        return self.frame_id

    def __repr__(self):
        return f"OT_{self.track_id}_({self.start_frame}-{self.end_frame})"


class BYTETracker:
    """The two-stage association of ByteTrack; see the module's text.

    `update(boxes (n, 4) xyxy, scores (n,), cls (n,), img=None)` advances
    one frame and returns (m, 8) rows [x1, y1, x2, y2, track_id, score,
    cls, detection row] of the activated tracks, the boxes the Kalman
    posterior's."""

    def __init__(self, args=None, frame_rate: int = 30):
        self.args = args or SimpleNamespace(
            track_high_thresh=0.5, track_low_thresh=0.1, new_track_thresh=0.6,
            track_buffer=30, match_thresh=0.8)
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        self.max_time_lost = int(frame_rate / 30.0 * self.args.track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, dets, scores, cls, img=None):
        return [STrack(xyxy_to_tlwh(d), s, c)
                for d, s, c in zip(dets, scores, cls)] if len(dets) else []

    def get_dists(self, tracks, detections):
        return fuse_score(iou_distance(tracks, detections), detections)

    def multi_predict(self, tracks):
        STrack.multi_predict(tracks)

    def update(self, boxes: np.ndarray, scores: np.ndarray, cls: np.ndarray,
               img=None) -> np.ndarray:
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []

        # strict on both sides: a score exactly at track_high_thresh is in
        # neither band
        high = scores > self.args.track_high_thresh
        low = (scores > self.args.track_low_thresh) & (scores < self.args.track_high_thresh)
        idx_all = np.arange(len(boxes))
        detections = self.init_track(boxes[high], scores[high], cls[high], img)
        for t, i in zip(detections, idx_all[high]):
            t.idx = int(i)

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)

        # 1: the high detections against the predicted pool
        self.multi_predict(strack_pool)
        dists = self.get_dists(strack_pool, detections)
        matches, u_track, u_det = linear_assignment(dists, self.args.match_thresh)
        for it, idet in matches:
            track, det = strack_pool[it], detections[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)

        # 2: the low band rescues the tracks still tracked
        detections_l = self.init_track(boxes[low], scores[low], cls[low], img)
        for t, i in zip(detections_l, idx_all[low]):
            t.idx = int(i)
        r_tracks = [strack_pool[i] for i in u_track
                    if strack_pool[i].state == TrackState.Tracked]
        matches, u_track2, _ = linear_assignment(iou_distance(r_tracks, detections_l), 0.5)
        for it, idet in matches:
            track, det = r_tracks[it], detections_l[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)
        for i in u_track2:
            t = r_tracks[i]
            if t.state != TrackState.Lost:
                t.mark_lost()
                lost.append(t)

        # 3: the unconfirmed tracks against the high detections left
        remaining = [detections[i] for i in u_det]
        dists = self.get_dists(unconfirmed, remaining)
        matches, u_unconfirmed, u_det2 = linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(remaining[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconfirmed:
            t = unconfirmed[i]
            t.mark_removed()
            removed.append(t)

        for i in u_det2:  # births
            det = remaining[i]
            if det.score >= self.args.new_track_thresh:
                det.activate(self.kalman_filter, self.frame_id)
                activated.append(det)

        for t in self.lost_stracks:  # deaths
            if self.frame_id - t.end_frame > self.max_time_lost:
                t.mark_removed()
                removed.append(t)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.removed_stracks)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks)
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        out = [np.concatenate([t.tlbr, [t.track_id, t.score, t.cls, t.idx]])
               for t in self.tracked_stracks if t.is_activated]
        return np.asarray(out, np.float32).reshape(-1, 8)


def xyxy_to_tlwh(b):
    return np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]], np.float32)


def joint_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    """`a`, then the tracks of `b` whose ID is not in `a`."""
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    """The tracks of `a` whose ID is not in `b`."""
    drop = {t.track_id for t in b}
    return [t for t in a if t.track_id not in drop]


def remove_duplicate_stracks(a: List[STrack], b: List[STrack]):
    """Of each pair of `a` x `b` with IoU above 0.85, drop the younger track."""
    pairs = np.where(iou_distance(a, b) < 0.15)
    dup_a, dup_b = set(), set()
    for ia, ib in zip(*pairs):
        if a[ia].frame_id - a[ia].start_frame > b[ib].frame_id - b[ib].start_frame:
            dup_b.add(ib)
        else:
            dup_a.add(ia)
    return ([t for i, t in enumerate(a) if i not in dup_a],
            [t for i, t in enumerate(b) if i not in dup_b])
