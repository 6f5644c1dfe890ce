"""Seeded synthetic scenes: coloured rectangles on textured noise, with their
labels.

A copy of the JAX package's `SyntheticDetectionDataset`
(`mgdt_yolo_tpu/data/dataset.py`), the scenes the committed weights were
trained on, so a benchmark feeds trained-density inputs and the trainer has
labelled data. Same seed, same pixels, same boxes.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

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


def task_labels(item: Dict, task: str, imgsz: int) -> Dict:
    """A scene's per-object planes for the segment and pose tasks, as the
    JAX dataset adds them: `masks` (n, s, s) float32, 1 inside each box's
    integer-truncated extent; `keypoints` (n, 17, 3), the top-left corner,
    the centre and the bottom-right corner visible (2), the other 14 at 0."""
    if task == "segment":
        masks = np.zeros((len(item["boxes"]), imgsz, imgsz), np.float32)
        for j, (x1, y1, x2, y2) in enumerate(item["boxes"]):
            masks[j, int(y1):int(y2), int(x1):int(x2)] = 1.0
        return {**item, "masks": masks}
    if task == "pose":
        k = np.zeros((len(item["boxes"]), 17, 3), np.float32)
        for j, (x1, y1, x2, y2) in enumerate(item["boxes"]):
            k[j, 0] = [x1, y1, 2]
            k[j, 1] = [(x1 + x2) / 2, (y1 + y2) / 2, 2]
            k[j, 2] = [x2, y2, 2]
        return {**item, "keypoints": k}
    return item


class SyntheticDetectionDataset:
    """`n` labelled scenes at `imgsz`; items as the JAX dataset's (`img` BGR
    uint8, `boxes` xyxy pixels, `cls`), with `masks` or `keypoints` for the
    `segment` and `pose` tasks (`task_labels`). `buffer` holds the train
    loader's last resized items, the mosaic and mixup partners, across
    epochs."""

    def __init__(self, n: int = 64, imgsz: int = 320, nc: int = 2,
                 max_objects: int = 6, seed: int = 0, task: str = "detect"):
        self.n, self.imgsz, self.nc = n, imgsz, nc
        self.max_objects, self.seed, self.task = max_objects, seed, task
        self.buffer: List[Dict] = []

    def __len__(self) -> int:
        return self.n

    def max_labels(self) -> int:
        return self.max_objects

    def shapes(self):
        """(h, w) of every scene: all square."""
        return [(self.imgsz, self.imgsz)] * self.n

    def __getitem__(self, i: int) -> Dict:
        """Scene `i` (`synthetic_item`) with the JAX dataset's file name,
        `synthetic_<i>.jpg`, as its `path`."""
        item = synthetic_item(i, self.imgsz, self.nc, self.max_objects, self.seed)
        return task_labels({**item, "path": f"synthetic_{i}.jpg"}, self.task, self.imgsz)


def synthetic_size(imgsz: int, task: str = "detect") -> int:
    """The scenes' size the JAX trainer picks without data: min(imgsz, 320),
    the full `imgsz` for the segment and pose tasks (their masks must
    match the train size)."""
    return imgsz if task in ("segment", "pose") else min(imgsz, 320)


def val_dataset(imgsz: int, nc: int = 2, seed: int = 0,
                task: str = "detect") -> SyntheticDetectionDataset:
    """The validation set the JAX trainer makes when it has no data
    (`BaseTrainer.get_dataset(train=False)`): 16 scenes at
    `synthetic_size` px from `seed + 1`; the validation loader letterboxes
    them to imgsz."""
    return SyntheticDetectionDataset(n=16, imgsz=synthetic_size(imgsz, task), nc=nc,
                                     seed=seed + 1, task=task)


# the camera's step each frame (x, y) in px, taken in turn: integer and
# sub-pixel pans, and a frame that stands still
PAN_STEPS = ((3.0, -2.0), (2.5, 1.25), (4.0, 0.0), (1.75, -0.5), (0.0, 0.0), (-2.0, 3.0),
             (3.5, 2.5), (1.0, -1.0))


def panning_sequence(n: int, shape=(1080, 1920), seed: int = 0, tile: int = 640):
    """`n` frames (h, w, 3) uint8 BGR of one synthetic scene under a camera
    that pans by `PAN_STEPS` in turn. The scene is a grid of synthetic scenes
    (`synthetic_item` i of `tile` px, row by row), so its objects keep the
    sizes the committed weights were trained on when a frame is letterboxed
    to `tile`'s scale; frame t is the window of the scene at offset o_t, cut
    by `imgproc.warp_affine` (cv2's bilinear warp), so the scene's content
    moves by -(o_t - o_{t-1}) from one frame to the next. Returns (frames,
    offsets (n, 2) float64, scene) with `scene` the whole scene's {"img",
    "boxes" (xyxy, its pixels), "cls"}."""
    from .imgproc import warp_affine
    h, w = shape
    steps = np.asarray([PAN_STEPS[t % len(PAN_STEPS)] for t in range(1, n)]).reshape(-1, 2)
    offsets = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, 0)])
    offsets -= offsets.min(0)
    cols, rows = (-(-(int(d + e) + 8) // tile) for d, e in zip((w, h), offsets.max(0)))
    img = np.empty((rows * tile, cols * tile, 3), np.uint8)
    boxes, cls = [], []
    for r in range(rows):
        for c in range(cols):
            item = synthetic_item(r * cols + c, tile, seed=seed)
            img[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = item["img"]
            boxes.append(item["boxes"] + np.array([c, r, c, r], np.float32) * tile)
            cls.append(item["cls"])
    scene = {"img": img, "boxes": np.concatenate(boxes), "cls": np.concatenate(cls)}
    def cut(offset):
        return warp_affine(img, np.array([[1.0, 0.0, -offset[0]], [0.0, 1.0, -offset[1]]]),
                           (w, h))

    with ThreadPoolExecutor(4) as pool:  # the warp's C++ runs without the GIL
        frames = list(pool.map(cut, offsets))
    return frames, offsets, scene
