"""YOLO-format datasets on disk: the counterpart of `img2label_path`,
`DetItem` and `YOLODataset` in `mgdt_yolo_tpu/data/dataset.py`.

A dataset is a directory of images (any depth) with their labels beside
them under `labels/` (`images/a/b.jpg` -> `labels/a/b.txt`, one `class cx
cy w h` row per object, normalized). The scan is verified and cached as the
JAX package's is (`data.utils.scan_labels`); items are decoded by the
port's decoder (`native.decode`, BGR as `cv2.imread` gives them).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from .utils import IMG_FORMATS, scan_labels

LOGGER = logging.getLogger(__name__)


def img2label_path(img_path: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt (the last `/images/` of the path);
    a path without one gets its suffix replaced by .txt."""
    p = str(img_path)
    if "/images/" in p:
        return p.rsplit("/images/", 1)[0] + "/labels/" + \
            p.rsplit("/images/", 1)[1].rsplit(".", 1)[0] + ".txt"
    return str(Path(img_path).with_suffix(".txt"))


@dataclass
class DetItem:
    img: np.ndarray          # HxWx3 uint8 BGR
    boxes: np.ndarray        # (n, 4) xyxy pixels
    cls: np.ndarray          # (n,) float32
    path: str = ""
    ori_shape: Tuple[int, int] = (0, 0)

    def asdict(self) -> Dict:
        return {"img": self.img, "boxes": self.boxes, "cls": self.cls,
                "path": self.path, "ori_shape": self.ori_shape}


class YOLODataset:
    """The images under `img_dir` with their YOLO txt labels, as the JAX
    `YOLODataset` takes them: files sorted, the first `fraction` of them
    kept, pairs verified and cached, corrupt ones dropped. `single_cls`
    sets every class to 0; `cache` keeps decoded images in memory
    ("ram"/True) or as `.npy` files beside them ("disk"). A file whose
    format the port does not decode (`bmp`, `tif`, `tiff`, `webp`) raises
    `native.UnsupportedFormat`, naming it. `buffer` holds the train
    loader's last resized items, the mosaic and mixup partners, across
    epochs."""

    def __init__(self, img_dir: str, fraction: float = 1.0, single_cls: bool = False,
                 cache=False, nc: Optional[int] = None, workers: int = 8):
        self.single_cls, self.cache = single_cls, cache
        self._ram: Dict[int, np.ndarray] = {}
        root = Path(img_dir)
        files = sorted(str(p) for p in root.rglob("*") if p.suffix[1:].lower() in IMG_FORMATS)
        if fraction < 1.0:
            files = files[:max(1, int(len(files) * fraction))]
        if not files:
            raise FileNotFoundError(f"no images found under {img_dir}")
        for f in files:
            native.check_format(f)
        label_files = [img2label_path(f) for f in files]
        cache_path = Path(label_files[0]).parent.with_suffix(".cache")
        records = scan_labels(files, label_files, cache_path, num_cls=nc, workers=workers)
        if not records:
            raise FileNotFoundError(f"no usable images under {img_dir}")
        self.im_files = [r["im_file"] for r in records]
        self.labels = [np.concatenate([r["cls"][:, None], r["xywh"]], 1).astype(np.float32)
                       if len(r["cls"]) else np.zeros((0, 5), np.float32) for r in records]
        self._shapes = [tuple(int(v) for v in r["shape"]) for r in records]
        LOGGER.info(f"dataset: {len(self.im_files)} images from {img_dir}")
        self.buffer: List[Dict] = []

    def __len__(self) -> int:
        return len(self.im_files)

    def max_labels(self) -> int:
        return max((len(lab) for lab in self.labels), default=0)

    def shapes(self):
        """(h, w) of every image, from the label scan (no decode): the
        rectangular validation plan's input."""
        return self._shapes

    def load_image(self, i: int) -> np.ndarray:
        """Image `i`, BGR uint8, through the cache when one is set."""
        if self.cache in (True, "ram") and i in self._ram:
            return self._ram[i]
        if self.cache == "disk":
            npy = Path(self.im_files[i]).with_suffix(".npy")
            if npy.is_file():
                return np.load(str(npy))
            img = native.decode(self.im_files[i])
            try:
                np.save(str(npy), img)
            except OSError:
                pass
            return img
        img = native.decode(self.im_files[i])
        if self.cache in (True, "ram"):
            self._ram[i] = img
        return img

    def __getitem__(self, i: int) -> Dict:
        img = self.load_image(i)
        h, w = img.shape[:2]
        lab = self.labels[i]
        cls = lab[:, 0].copy()
        if self.single_cls:
            cls[:] = 0
        xywh = lab[:, 1:5]
        boxes = np.empty_like(xywh)
        boxes[:, 0] = (xywh[:, 0] - xywh[:, 2] / 2) * w
        boxes[:, 1] = (xywh[:, 1] - xywh[:, 3] / 2) * h
        boxes[:, 2] = (xywh[:, 0] + xywh[:, 2] / 2) * w
        boxes[:, 3] = (xywh[:, 1] + xywh[:, 3] / 2) * h
        return DetItem(img, boxes.astype(np.float32), cls, self.im_files[i], (h, w)).asdict()
