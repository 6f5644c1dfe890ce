"""Training batches: padded targets and a seeded loader, the counterparts of
`collate` and `DataLoader` in `mgdt_yolo_tpu/data/build.py`, cut to what
unaugmented training needs (items already square at the train size).
"""
from __future__ import annotations

import math
import random
from typing import Dict, Iterator

import numpy as np
import torch


def pad_boxes(boxes, cls, max_gt: int):
    """Per-image xyxy pixel boxes [(n_j, 4)] and classes [(n_j,)] -> padded
    `gt_labels` (b, max_gt) int32, `gt_bboxes` (b, max_gt, 4) float32 and
    `mask_gt` (b, max_gt) bool; boxes past `max_gt` are dropped."""
    b = len(boxes)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_bboxes = np.zeros((b, max_gt, 4), np.float32)
    mask_gt = np.zeros((b, max_gt), bool)
    for j, (bb, c) in enumerate(zip(boxes, cls)):
        n = min(len(bb), max_gt)
        if n:
            gt_bboxes[j, :n] = bb[:n]
            gt_labels[j, :n] = np.asarray(c)[:n].reshape(-1).astype(np.int32)
            mask_gt[j, :n] = gt_bboxes[j, :n].sum(-1) > 0
    return gt_labels, gt_bboxes, mask_gt


def collate(items, imgsz: int, max_gt: int) -> Dict[str, np.ndarray]:
    """Stack square (imgsz) items into one batch: `img` (b, imgsz, imgsz, 3)
    uint8 RGB and the targets of `pad_boxes`."""
    imgs = np.empty((len(items), imgsz, imgsz, 3), np.uint8)
    for j, it in enumerate(items):
        imgs[j] = it["img"][..., ::-1]  # BGR -> RGB, stays uint8
    gt_labels, gt_bboxes, mask_gt = pad_boxes([it["boxes"] for it in items],
                                              [it["cls"] for it in items], max_gt)
    return {"img": imgs, "gt_labels": gt_labels, "gt_bboxes": gt_bboxes,
            "mask_gt": mask_gt}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated batch as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class DataLoader:
    """Seeded training loader: a per-epoch shuffle (`seed + epoch`, as the
    JAX loader shuffles), short batches dropped, targets padded to
    `max_gt = ceil(4 * dataset.max_labels() / 8) * 8`, the JAX train
    loader's room for a 4-image mosaic."""

    def __init__(self, dataset, batch_size: int, imgsz: int, seed: int = 0):
        self.dataset, self.batch_size, self.imgsz = dataset, batch_size, imgsz
        self.seed, self.epoch = seed, 0
        self.max_gt = int(math.ceil(max(1, dataset.max_labels()) * 4 / 8) * 8)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = list(range(len(self.dataset)))
        random.Random(self.seed + self.epoch).shuffle(idx)
        for k in range(len(self)):
            chunk = idx[k * self.batch_size:(k + 1) * self.batch_size]
            yield collate([self.dataset[i] for i in chunk], self.imgsz, self.max_gt)
