"""Annotated images, batch mosaics and crops: the counterpart of the JAX
package's `mgdt_yolo_tpu/utils/plotting.py`, drawn and written by the port's
own rasteriser and writers (`utils/draw.py`) with JAX's arithmetic: the
line width `max(round(sum(shape) / 2 * 0.003), 2)`, the label box above
the box where it fits, the `gain * wh + pad` crop, BGR images in and out.
The charts (`plot_labels`, `plot_results`, `plot_pr_curves`,
`feature_visualization`) are in `utils/charts.py` and re-exported here.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import draw
from .charts import feature_visualization, plot_labels, plot_pr_curves, plot_results  # noqa: F401

PALETTE = [(56, 56, 255), (31, 112, 255), (29, 178, 255), (49, 210, 207),
           (10, 249, 72), (23, 204, 146), (134, 219, 61), (52, 147, 26),
           (187, 212, 0), (168, 153, 44), (255, 194, 0), (147, 69, 52),
           (255, 115, 100), (236, 24, 0), (255, 56, 132), (133, 0, 82),
           (255, 56, 203), (200, 149, 255), (199, 55, 255)]


def color(i: int):
    return PALETTE[int(i) % len(PALETTE)]


def default_line_width(shape) -> int:
    """JAX's default line width of an image of `shape`."""
    return max(round(sum(shape) / 2 * 0.003), 2)


class Annotator:
    """Boxes with labels, masks and keypoints drawn on a BGR uint8 image,
    in place (a read-only or non-contiguous image is copied first)."""

    def __init__(self, img: np.ndarray, line_width: Optional[int] = None):
        self.img = img if img.flags.writeable and img.flags.c_contiguous \
            else np.ascontiguousarray(img).copy()
        self.lw = line_width or default_line_width(img.shape)

    def box_label(self, box, label: str = "", color=(128, 128, 128),
                  txt_color=(255, 255, 255)):
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        draw.rectangle(self.img, p1, p2, color, self.lw, draw.LINE_AA)
        if label:
            tf = max(self.lw - 1, 1)
            w, h = draw.get_text_size(label, self.lw / 3, tf)[0]
            outside = p1[1] - h >= 3
            p2t = (p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3)
            draw.rectangle(self.img, p1, p2t, color, -1, draw.LINE_AA)
            draw.put_text(self.img, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2),
                          self.lw / 3, txt_color, tf, draw.LINE_AA)

    def masks(self, masks: np.ndarray, colors: Sequence, alpha: float = 0.5):
        """masks: (n, H, W) bool, each blended with its colour."""
        overlay = self.img.astype(np.float32)
        for m, c in zip(masks, colors):
            overlay[m] = overlay[m] * (1 - alpha) + np.asarray(c) * alpha
        self.img[:] = overlay.astype(np.uint8)

    def kpts(self, kpts: np.ndarray, radius: int = 5):
        """(k, 2|3) keypoints; those of confidence above 0.5 as green dots."""
        for x, y, *rest in kpts:
            conf = rest[0] if rest else 1.0
            if conf > 0.5:
                draw.circle(self.img, (int(x), int(y)), radius, (0, 255, 0), -1)

    def result(self):
        return self.img


def plot_images(images: np.ndarray, batch_boxes: List[np.ndarray],
                names: Dict[int, str], fname: str = "batch.jpg",
                max_images: int = 16):
    """A square grid of up to `max_images` images, each with its boxes and
    class names, white where the grid has no image, written to `fname`.

    images: (b, H, W, 3) float RGB in [0, 1]; batch_boxes: per image (n, 6)
    rows [x1, y1, x2, y2, conf, cls] in its pixels.
    """
    b = min(len(images), max_images)
    n = int(np.ceil(b ** 0.5))
    h, w = images.shape[1:3]
    grid = np.full((n * h, n * w, 3), 255, np.uint8)
    for i in range(b):
        r, c = divmod(i, n)
        img = (images[i, ..., ::-1] * 255).astype(np.uint8)
        ann = Annotator(img.copy())
        for row in (batch_boxes[i] if i < len(batch_boxes) else []):
            cls = int(row[5]) if len(row) > 5 else 0
            ann.box_label(row[:4], f"{names.get(cls, cls)}", color(cls))
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = ann.result()
    Path(fname).parent.mkdir(parents=True, exist_ok=True)
    draw.imwrite(str(fname), grid)
    return fname


def save_one_box(xyxy, im: np.ndarray, file="im.jpg", gain: float = 1.02,
                 pad: int = 10, square: bool = False, BGR: bool = False,
                 save: bool = True):
    """The crop of a BGR image around a box grown to `gain * wh + pad`
    (square with `square`), clipped to the image: BGR with `BGR`, else RGB.
    With `save` it is written (BGR) to `file` as a JPEG, numbered where the
    name is taken."""
    r = np.asarray(xyxy, np.float32).reshape(-1, 4)[0]
    cx, cy = (r[0] + r[2]) / 2, (r[1] + r[3]) / 2
    bw, bh = r[2] - r[0], r[3] - r[1]
    if square:
        bw = bh = max(bw, bh)
    bw, bh = bw * gain + pad, bh * gain + pad  # +pad in all, not per side
    box = np.array([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], int)
    h, w = im.shape[:2]
    x1, y1 = max(box[0], 0), max(box[1], 0)
    x2, y2 = min(box[2], w), min(box[3], h)
    crop = im[y1:y2, x1:x2, ::(1 if BGR else -1)]
    if save:
        from .settings import increment_path
        f = Path(increment_path(Path(file))).with_suffix(".jpg")
        f.parent.mkdir(parents=True, exist_ok=True)
        draw.imwrite(f, np.ascontiguousarray(crop if BGR else crop[..., ::-1]))
    return crop
