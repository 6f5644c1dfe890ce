"""Format-aware box and instance containers, numpy only: the port's own copy
of `mgdt_yolo_tpu/utils/instance.py` (`Bboxes` in xyxy, xywh or ltwh;
`Instances` carrying boxes with their segments and keypoints through
scaling, padding, clipping and flips).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

_FORMATS = ("xyxy", "xywh", "ltwh")


def _to_xyxy(b: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "xyxy":
        return b.copy()
    out = b.copy()
    if fmt == "xywh":
        out[:, 0] = b[:, 0] - b[:, 2] / 2
        out[:, 1] = b[:, 1] - b[:, 3] / 2
        out[:, 2] = b[:, 0] + b[:, 2] / 2
        out[:, 3] = b[:, 1] + b[:, 3] / 2
    else:  # ltwh
        out[:, 2] = b[:, 0] + b[:, 2]
        out[:, 3] = b[:, 1] + b[:, 3]
    return out


def _from_xyxy(b: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "xyxy":
        return b.copy()
    out = b.copy()
    if fmt == "xywh":
        out[:, 0] = (b[:, 0] + b[:, 2]) / 2
        out[:, 1] = (b[:, 1] + b[:, 3]) / 2
        out[:, 2] = b[:, 2] - b[:, 0]
        out[:, 3] = b[:, 3] - b[:, 1]
    else:
        out[:, 2] = b[:, 2] - b[:, 0]
        out[:, 3] = b[:, 3] - b[:, 1]
    return out


class Bboxes:
    """Box container with explicit format (reference instance.py:33-183)."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy"):
        assert format in _FORMATS, format
        bboxes = bboxes[None] if bboxes.ndim == 1 else bboxes
        assert bboxes.ndim == 2 and bboxes.shape[1] == 4
        self.bboxes = bboxes.astype(np.float32)
        self.format = format

    def convert(self, format: str):
        assert format in _FORMATS
        if format != self.format:
            self.bboxes = _from_xyxy(_to_xyxy(self.bboxes, self.format), format)
            self.format = format
        return self

    def areas(self) -> np.ndarray:
        b = _to_xyxy(self.bboxes, self.format)
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def mul(self, scale):
        s = np.asarray(scale if hasattr(scale, "__len__") else [scale] * 4)
        self.bboxes = self.bboxes * s
        return self

    def add(self, offset):
        o = np.asarray(offset if hasattr(offset, "__len__") else [offset] * 4)
        self.bboxes = self.bboxes + o
        return self

    def __len__(self):
        return len(self.bboxes)

    @classmethod
    def concatenate(cls, lst: List["Bboxes"], axis: int = 0) -> "Bboxes":
        assert lst
        fmt = lst[0].format
        return cls(np.concatenate([b.convert(fmt).bboxes for b in lst], axis), fmt)

    def __getitem__(self, idx) -> "Bboxes":
        return Bboxes(np.atleast_2d(self.bboxes[idx]), self.format)


class Instances:
    """Boxes + segments + keypoints moving together through augmentation
    (reference instance.py:184-391)."""

    def __init__(self, bboxes: np.ndarray, segments: Optional[np.ndarray] = None,
                 keypoints: Optional[np.ndarray] = None,
                 bbox_format: str = "xywh", normalized: bool = True):
        self._bboxes = Bboxes(bboxes, bbox_format)
        self.segments = segments if segments is not None else np.zeros((0, 0, 2),
                                                                       np.float32)
        self.keypoints = keypoints
        self.normalized = normalized

    @property
    def bboxes(self):
        return self._bboxes.bboxes

    @property
    def bbox_areas(self):
        return self._bboxes.areas()

    def convert_bbox(self, format: str):
        self._bboxes.convert(format)
        return self

    def scale(self, sw: float, sh: float, bbox_only: bool = False):
        self._bboxes.mul((sw, sh, sw, sh))
        if not bbox_only:
            if self.segments.size:
                self.segments[..., 0] *= sw
                self.segments[..., 1] *= sh
            if self.keypoints is not None:
                self.keypoints[..., 0] *= sw
                self.keypoints[..., 1] *= sh
        return self

    def denormalize(self, w: int, h: int):
        if self.normalized:
            self.scale(w, h)
            self.normalized = False
        return self

    def normalize(self, w: int, h: int):
        if not self.normalized:
            self.scale(1 / w, 1 / h)
            self.normalized = True
        return self

    def add_padding(self, padw: float, padh: float):
        assert not self.normalized, "padding applies to pixel coords"
        self._bboxes.add((padw, padh, padw, padh))
        if self.segments.size:
            self.segments[..., 0] += padw
            self.segments[..., 1] += padh
        if self.keypoints is not None:
            self.keypoints[..., 0] += padw
            self.keypoints[..., 1] += padh
        return self

    def clip(self, w: int, h: int):
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        self._bboxes.bboxes[:, [0, 2]] = self._bboxes.bboxes[:, [0, 2]].clip(0, w)
        self._bboxes.bboxes[:, [1, 3]] = self._bboxes.bboxes[:, [1, 3]].clip(0, h)
        self.convert_bbox(fmt)
        if self.segments.size:
            self.segments[..., 0] = self.segments[..., 0].clip(0, w)
            self.segments[..., 1] = self.segments[..., 1].clip(0, h)
        if self.keypoints is not None:  # reference instance.py:316-328
            self.keypoints[..., 0] = self.keypoints[..., 0].clip(0, w)
            self.keypoints[..., 1] = self.keypoints[..., 1].clip(0, h)
        return self

    def flipud(self, h: int):
        """Flip boxes AND segments/keypoints (reference instance.py:290-302)."""
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        y1 = self._bboxes.bboxes[:, 1].copy()
        self._bboxes.bboxes[:, 1] = h - self._bboxes.bboxes[:, 3]
        self._bboxes.bboxes[:, 3] = h - y1
        self.convert_bbox(fmt)
        if self.segments.size:
            self.segments[..., 1] = h - self.segments[..., 1]
        if self.keypoints is not None:
            self.keypoints[..., 1] = h - self.keypoints[..., 1]
        return self

    def fliplr(self, w: int):
        """Flip boxes AND segments/keypoints (reference instance.py:304-314)."""
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        x1 = self._bboxes.bboxes[:, 0].copy()
        self._bboxes.bboxes[:, 0] = w - self._bboxes.bboxes[:, 2]
        self._bboxes.bboxes[:, 2] = w - x1
        self.convert_bbox(fmt)
        if self.segments.size:
            self.segments[..., 0] = w - self.segments[..., 0]
        if self.keypoints is not None:
            self.keypoints[..., 0] = w - self.keypoints[..., 0]
        return self

    def remove_zero_area_boxes(self) -> np.ndarray:
        good = self.bbox_areas > 0
        if not good.all():
            self._bboxes = self._bboxes[good]
            if self.segments.size:
                self.segments = self.segments[good]
            if self.keypoints is not None:
                self.keypoints = self.keypoints[good]
        return good

    def __len__(self):
        return len(self._bboxes)

    def __getitem__(self, idx) -> "Instances":
        return Instances(np.atleast_2d(self.bboxes[idx]),
                         self.segments[idx] if self.segments.size else self.segments,
                         self.keypoints[idx] if self.keypoints is not None else None,
                         self._bboxes.format, self.normalized)
