"""Per-image results: `Boxes`, `Masks`, `Keypoints`, `Probs` and `Results`,
the counterparts of the JAX package's `mgdt_yolo_tpu/engine/results.py`.

numpy-backed, as there: the predictor and the server bring detections back
to the host, rescaled to the original image, and wrap them here (as in JAX,
the predictor gives boxes only; masks and keypoints are a caller's).
`cpu`, `numpy`, `cuda` and `to` return the object itself. `plot` and
`save_crop` draw and write with the port's rasteriser and writers
(`utils/draw.py`, `utils/plotting.py`); `plot` draws the boxes, as JAX's.
`Masks.xy` takes each mask's largest outer contour by the port's border
follower (`utils/contours.py`, cv2's `findContours` without cv2). A
classify result holds `probs` and no boxes: `verbose` gives its top five,
`save_crop` and `tojson` warn and do nothing, and `plot`, which draws the
boxes, gives the image unchanged, as JAX's.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

LOGGER = logging.getLogger(__name__)
PLOT_PALETTE = [(56, 56, 255), (31, 112, 255), (29, 178, 255), (49, 210, 207),
                (10, 249, 72), (23, 204, 146), (134, 219, 61), (52, 147, 26)]


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


class Masks(SimpleClass, _HostOps):
    """(n, H, W) instance masks in the original image's pixels."""

    def __init__(self, masks: np.ndarray, orig_shape):
        self.data = np.atleast_3d(np.asarray(masks))
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self):
        """Each mask's largest outer contour (by `contour_area`, the first of
        equal ones in cv2's order), (k, 2) float32 pixels; (0, 2) for an
        empty mask."""
        from ..utils.contours import contour_area, find_external_contours
        out = []
        for m in self.data:
            cnts = find_external_contours(m.astype(np.uint8))
            out.append(max(cnts, key=contour_area).reshape(-1, 2).astype(np.float32)
                       if cnts else np.zeros((0, 2), np.float32))
        return out

    @property
    def xyn(self):
        """`xy` divided by the image's (w, h)."""
        h, w = np.asarray(self.orig_shape)[:2]
        return [c / np.array([w, h], np.float32) for c in self.xy]


class Keypoints(SimpleClass, _HostOps):
    """(n, k, 2|3) keypoints in the original image's pixels, a visibility
    or confidence last where there are 3 values."""

    def __init__(self, kpts: np.ndarray, orig_shape):
        self.data = np.asarray(kpts)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None

    @property
    def xyn(self):
        h, w = np.asarray(self.orig_shape)[:2]
        return self.xy / np.array([w, h], np.float32)


class Probs(SimpleClass, _HostOps):
    """(nc,) classification probabilities."""

    def __init__(self, probs: np.ndarray):
        self.data = np.asarray(probs)

    def __len__(self):
        return len(self.data)

    @property
    def top1(self):
        return int(self.data.argmax())

    @property
    def top5(self):
        return self.data.argsort()[::-1][:5].tolist()

    @property
    def top1conf(self):
        return float(self.data.max())

    @property
    def top5conf(self):
        return self.data[self.top5].tolist()


class Results(SimpleClass):
    """One image's detections (`boxes`, with `masks` and `keypoints` where
    given) or class probabilities (`probs`), its original BGR image, its
    source name and the per-image `speed` (ms) of preprocess and
    inference."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str],
                 boxes: Optional[np.ndarray] = None, masks: Optional[np.ndarray] = None,
                 probs: Optional[np.ndarray] = None, keypoints: Optional[np.ndarray] = None,
                 speed: Optional[Dict[str, float]] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None and len(boxes) else np.zeros((0, 6)),
                           self.orig_shape)
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None \
            else None
        self.probs = Probs(probs) if probs is not None else None
        self.speed = speed or {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}

    def __len__(self):
        return len(self.boxes)

    def __getitem__(self, idx):
        return Results(self.orig_img, self.path, self.names,
                       self.boxes.data[idx] if len(self.boxes) else None, speed=self.speed)

    def update(self, boxes: Optional[np.ndarray] = None, masks: Optional[np.ndarray] = None,
               probs: Optional[np.ndarray] = None):
        """Replace the detections, the masks or the probabilities in place."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        if probs is not None:
            self.probs = Probs(probs)
        return self

    def new(self):
        """Empty Results over the same image."""
        return Results(self.orig_img, self.path, self.names)

    @property
    def keys(self):
        """Names of the non-empty result attributes."""
        return [k for k in ("boxes", "masks", "probs", "keypoints")
                if getattr(self, k) is not None and len(getattr(self, k))]

    def cpu(self):
        return self

    def numpy(self):
        return self

    def cuda(self):
        return self

    def to(self, *args, **kwargs):
        return self

    def verbose(self) -> str:
        """Per-class summary, "2 0s, 1 1, " (the reference's log line); for
        probabilities the top five, "<name> 0.31, ..., "."""
        if self.probs is not None:
            return ", ".join(f"{self.names.get(j, j)} {float(self.probs.data[j]):.2f}"
                             for j in self.probs.top5) + ", "
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

    def plot(self, line_width: Optional[int] = None, font_scale: float = 0.5) -> np.ndarray:
        """The detections drawn on a copy of the original (BGR) image, as
        JAX's `plot` draws them: per class a colour of an 8-colour palette,
        a `LINE_8` box and "<name> <conf>" at (x1, max(y1 - 4, 12))."""
        from ..utils import draw
        img = np.ascontiguousarray(self.orig_img).copy()
        lw = line_width or max(round(sum(img.shape) / 2 * 0.003), 2)
        for row in self.boxes.data:
            x1, y1, x2, y2 = row[:4].astype(int)
            conf, c = row[-2], int(row[-1])
            color = PLOT_PALETTE[c % len(PLOT_PALETTE)]
            draw.rectangle(img, (x1, y1), (x2, y2), color, lw)
            draw.put_text(img, f"{self.names.get(c, c)} {conf:.2f}", (x1, max(y1 - 4, 12)),
                          font_scale, color, max(lw - 1, 1))
        return img

    def save_crop(self, save_dir, file_name="im.jpg"):
        """Each detection's crop (BGR, `utils.plotting.save_one_box`) to
        `<save_dir>/<class name>/<stem>.jpg`, numbered where taken; a
        classify result warns and writes nothing, as JAX's."""
        if self.probs is not None:
            LOGGER.warning("Classify task does not support save_crop")
            return
        from ..utils.plotting import save_one_box
        save_dir = Path(save_dir)
        stem = Path(file_name).stem
        for row in self.boxes.data:
            cname = str(self.names.get(int(row[-1]), int(row[-1])))
            save_one_box(row[:4], self.orig_img.copy(), file=save_dir / cname / f"{stem}.jpg",
                         BGR=True)

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
        (, track_id, segments {x, y}, keypoints {x, y, visible})},
        coordinates divided by the image size when `normalize`, as JAX's
        `tojson` writes them (the i-th mask's and keypoints' with the i-th
        box); a classify result warns and gives None, as JAX's."""
        if self.probs is not None:
            LOGGER.warning("Classify task does not support tojson yet")
            return None
        h, w = self.orig_shape if normalize else (1, 1)
        out = []
        for i, row in enumerate(self.boxes.data):
            c = int(row[-1])
            rec = {"name": str(self.names.get(c, c)), "class": c, "confidence": float(row[-2]),
                   "box": {"x1": float(row[0]) / w, "y1": float(row[1]) / h,
                           "x2": float(row[2]) / w, "y2": float(row[3]) / h}}
            if self.boxes.is_track:
                rec["track_id"] = int(row[-3])
            if self.masks is not None and len(self.masks):
                xy = self.masks.xy[i]
                rec["segments"] = {"x": (xy[:, 0] / w).tolist(), "y": (xy[:, 1] / h).tolist()}
            if self.keypoints is not None and len(self.keypoints):
                kp = self.keypoints.data[i]
                rec["keypoints"] = {"x": (kp[:, 0] / w).tolist(), "y": (kp[:, 1] / h).tolist(),
                                    "visible": (kp[:, 2].tolist() if kp.shape[-1] == 3
                                                else [1.0] * len(kp))}
            out.append(rec)
        return json.dumps(out, indent=2)
