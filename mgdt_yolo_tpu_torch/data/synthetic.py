"""Seeded synthetic scenes: coloured rectangles on textured noise, with their
labels.

A copy of the JAX package's `SyntheticDetectionDataset`
(`mgdt_yolo_tpu/data/dataset.py`, unaugmented), the scenes the committed
weights were trained on, so a benchmark feeds trained-density inputs and the
trainer has labelled data. Same seed, same pixels, same boxes. The JAX
trainer resizes its 320 px training scenes to the train size with cv2; the
port makes them at the train size instead.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# per-class base colours (BGR)
_BASE = [(40, 40, 200), (200, 60, 40), (40, 200, 60), (200, 200, 40),
         (200, 40, 200), (40, 200, 200)]


def synthetic_item(i: int, imgsz: int = 320, nc: int = 2, max_objects: int = 6,
                   seed: int = 0) -> Dict:
    """Scene `i`: {"img": (imgsz, imgsz, 3) uint8 BGR, "boxes": (n, 4)
    float32 xyxy pixels, "cls": (n,) float32}."""
    rng = np.random.default_rng(seed * 100003 + i)
    s = imgsz
    img = rng.uniform(90, 150, (s, s, 3)).astype(np.uint8)
    boxes, cls = [], []
    for _ in range(int(rng.integers(1, max_objects + 1))):
        w = float(rng.uniform(0.12, 0.4) * s)
        h = float(rng.uniform(0.12, 0.4) * s)
        x1 = float(rng.uniform(0, s - w))
        y1 = float(rng.uniform(0, s - h))
        c = int(rng.integers(0, nc))
        color = np.array(_BASE[c % len(_BASE)], float) + rng.uniform(-25, 25, 3)
        img[int(y1):int(y1 + h), int(x1):int(x1 + w)] = np.clip(color, 0, 255)
        boxes.append([x1, y1, x1 + w, y1 + h])
        cls.append(c)
    return {"img": img, "boxes": np.asarray(boxes, np.float32),
            "cls": np.asarray(cls, np.float32)}


def synthetic_scene(i: int, imgsz: int = 320, nc: int = 2, max_objects: int = 6,
                    seed: int = 0) -> np.ndarray:
    """Scene `i` as a (imgsz, imgsz, 3) uint8 BGR image."""
    return synthetic_item(i, imgsz, nc, max_objects, seed)["img"]


def synthetic_batch(batch: int, imgsz: int = 640, nc: int = 2, n: int = 64,
                    seed: int = 7) -> np.ndarray:
    """`n` distinct RGB scenes tiled to `batch` images: (batch, imgsz, imgsz, 3)
    uint8, as the JAX benchmark builds its input."""
    tile = np.stack([synthetic_scene(i, imgsz, nc, seed=seed)[..., ::-1]
                     for i in range(min(n, batch))])
    reps = -(-batch // len(tile))
    return np.ascontiguousarray(np.tile(tile, (reps, 1, 1, 1))[:batch])


class SyntheticDetectionDataset:
    """`n` labelled scenes at `imgsz`, unaugmented; items as the JAX
    dataset's (`img` BGR uint8, `boxes` xyxy pixels, `cls`)."""

    def __init__(self, n: int = 64, imgsz: int = 320, nc: int = 2,
                 max_objects: int = 6, seed: int = 0):
        self.n, self.imgsz, self.nc = n, imgsz, nc
        self.max_objects, self.seed = max_objects, seed

    def __len__(self) -> int:
        return self.n

    def max_labels(self) -> int:
        return self.max_objects

    def __getitem__(self, i: int) -> Dict:
        return synthetic_item(i, self.imgsz, self.nc, self.max_objects, self.seed)


def val_dataset(imgsz: int, nc: int = 2, seed: int = 0) -> SyntheticDetectionDataset:
    """The validation set the JAX trainer makes when it has no data
    (`BaseTrainer.get_dataset(train=False)`): 16 scenes at min(imgsz, 320)
    px from `seed + 1`; the validation loader letterboxes them to imgsz."""
    return SyntheticDetectionDataset(n=16, imgsz=min(imgsz, 320), nc=nc, seed=seed + 1)
