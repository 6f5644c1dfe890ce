"""Per-image results: `Boxes` and `Results`, the detect parts of the JAX
package's `mgdt_yolo_tpu/engine/results.py`.

numpy-backed, as there: the predictor and the server bring detections back
to the host, rescaled to the original image, and wrap them here. `cpu`,
`numpy`, `cuda` and `to` return the object itself. Not ported: drawing
(`plot`, `save_crop`), which needs a renderer without cv2 (ROADMAP queue 1,
item 5), and the masks, keypoints and probabilities of the segment, pose
and classify tasks (item 8).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

NOT_DRAWN = "drawing without cv2 is not ported yet (ROADMAP queue 1, item 5)"


class SimpleClass:
    """Readable reprs and helpful attribute errors, as the JAX package's."""

    def __str__(self):
        attr = []
        for a in dir(self):
            v = getattr(self, a)
            if not callable(v) and not a.startswith("_"):
                attr.append(f"{a}: {v.__class__.__module__}.{v.__class__.__name__} object")
        return (f"{self.__module__}.{self.__class__.__name__} object with attributes:\n\n" +
                "\n".join(attr))

    def __repr__(self):
        return self.__str__()

    def __getattr__(self, attr):
        name = self.__class__.__name__
        raise AttributeError(f"'{name}' object has no attribute '{attr}'. See valid "
                             f"attributes below.\n{self.__doc__}")


class _HostOps:
    """The reference's device-handling surface; the data is numpy already."""

    @property
    def shape(self):
        return self.data.shape

    def cpu(self):
        return self

    def numpy(self):
        return self

    def cuda(self):
        return self

    def to(self, *args, **kwargs):
        return self


class Boxes(SimpleClass, _HostOps):
    """(n, 6|7) detection rows [x1, y1, x2, y2, (track_id), conf, cls] in
    the original image's pixels."""

    def __init__(self, boxes: np.ndarray, orig_shape):
        boxes = np.atleast_2d(np.asarray(boxes))
        n = boxes.shape[-1]
        if n not in (6, 7):
            raise ValueError(f"expected 6 or 7 values per box, got {n}")
        self.data = boxes
        self.orig_shape = np.asarray(orig_shape)
        self.is_track = n == 7

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Boxes(self.data[idx], self.orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        return self.data[:, -3] if self.is_track else None

    @property
    def xywh(self):
        b = self.xyxy
        return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                         b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape[:2]
        return self.xyxy / np.array([w, h, w, h])

    @property
    def xywhn(self):
        h, w = self.orig_shape[:2]
        return self.xywh / np.array([w, h, w, h])


class Results(SimpleClass):
    """One image's detections (`boxes`), its original BGR image, its source
    name and the per-image `speed` (ms) of preprocess and inference."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str],
                 boxes: Optional[np.ndarray] = None, speed: Optional[Dict[str, float]] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None and len(boxes) else np.zeros((0, 6)),
                           self.orig_shape)
        self.masks = self.probs = self.keypoints = None  # other tasks: item 8
        self.speed = speed or {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}

    def __len__(self):
        return len(self.boxes)

    def __getitem__(self, idx):
        return Results(self.orig_img, self.path, self.names,
                       self.boxes.data[idx] if len(self.boxes) else None, speed=self.speed)

    def update(self, boxes: Optional[np.ndarray] = None):
        """Replace the detections in place."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        return self

    def new(self):
        """Empty Results over the same image."""
        return Results(self.orig_img, self.path, self.names)

    @property
    def keys(self):
        """Names of the non-empty result attributes."""
        return ["boxes"] if len(self.boxes) else []

    def cpu(self):
        return self

    def numpy(self):
        return self

    def cuda(self):
        return self

    def to(self, *args, **kwargs):
        return self

    def verbose(self) -> str:
        """Per-class summary, "2 0s, 1 1, " (the reference's log line)."""
        if len(self) == 0:
            return "(no detections), "
        out = ""
        cls = self.boxes.cls.astype(int)
        for c in sorted(set(cls.tolist())):
            n = int((cls == c).sum())
            out += f"{n} {self.names.get(c, c)}{'s' * (n > 1)}, "
        return out

    def counts(self) -> Dict[int, int]:
        """Detections per class, the paper's counting primitive."""
        out: Dict[int, int] = {}
        for c in self.boxes.cls.astype(int):
            out[c] = out.get(c, 0) + 1
        return out

    def plot(self, *args, **kwargs):
        raise NotImplementedError(NOT_DRAWN)

    def save_crop(self, *args, **kwargs):
        raise NotImplementedError(NOT_DRAWN)

    def save_txt(self, txt_file, save_conf: bool = False):
        """One line per detection, "cls x y w h [conf]", normalised xywh."""
        lines = []
        for row in self.boxes.data:
            c = int(row[-1])
            xywhn = Boxes(row[None], self.orig_shape).xywhn[0]
            vals = [c, *xywhn.tolist()] + ([float(row[-2])] if save_conf else [])
            lines.append(" ".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                                  for v in vals))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))

    def tojson(self, normalize: bool = False):
        """The detections as a JSON list of {name, class, confidence, box
        (, track_id)}, boxes divided by the image size when `normalize`."""
        h, w = self.orig_shape if normalize else (1, 1)
        out = []
        for row in self.boxes.data:
            c = int(row[-1])
            rec = {"name": str(self.names.get(c, c)), "class": c, "confidence": float(row[-2]),
                   "box": {"x1": float(row[0]) / w, "y1": float(row[1]) / h,
                           "x2": float(row[2]) / w, "y2": float(row[3]) / h}}
            if self.boxes.is_track:
                rec["track_id"] = int(row[-3])
            out.append(rec)
        return json.dumps(out, indent=2)
