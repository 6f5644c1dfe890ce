"""Batches: padded targets and a seeded loader, the counterparts of
`collate`, `collate_raw` and `DataLoader` in `mgdt_yolo_tpu/data/build.py`.

Three kinds of batch, as the JAX loader makes them:

* train, `device_augment=False`: square items already at the train size,
  stacked unaugmented (`collate`);
* train, `device_augment=True`: raw top-left-anchored uint8 squares with
  their content size `img_hw` and unaugmented labels (`collate_raw`); the
  trainer augments them on the device (`ops/device_augment.py`);
* validation (`train=False`): each item letterboxed to the square by
  padding only (`letterbox`), with `metas` holding the `ratio_pad` that
  maps boxes back.

Items larger than the batch's square would need a resize, and a resize
that matches cv2's `INTER_LINEAR` bit for bit is not ported: such items
raise.
"""
from __future__ import annotations

import math
import random
from typing import Dict, Iterator

import numpy as np
import torch

PAD_VALUE = 114


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


def letterbox(img: np.ndarray, new_shape=(640, 640)):
    """Centre `img` (h, w, 3) on a `new_shape` (h, w) canvas of 114 by
    padding, as the JAX `letterbox` does with `scaleup=False` when no resize
    is needed (the reference's +-0.1 rounding of the two pads). Returns
    (img, ratio, (dw, dh)). Raises if the image is larger than the canvas."""
    shape = img.shape[:2]
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1], 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    if shape[::-1] != new_unpad:
        raise ValueError(f"letterboxing a {shape[1]}x{shape[0]} image into "
                         f"{new_shape[1]}x{new_shape[0]} needs a resize, which is not ported")
    dw, dh = (new_shape[1] - new_unpad[0]) / 2, (new_shape[0] - new_unpad[1]) / 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.empty((shape[0] + top + bottom, shape[1] + left + right, 3), img.dtype)
    out[...] = PAD_VALUE
    out[top:top + shape[0], left:left + shape[1]] = img
    return out, (r, r), (dw, dh)


def collate(items, imgsz: int, max_gt: int, train: bool = True) -> Dict[str, np.ndarray]:
    """Stack items into one batch: `img` (b, imgsz, imgsz, 3) uint8 RGB and
    the targets of `pad_boxes`. Train items must already be square at
    `imgsz`; validation items are letterboxed (pad only) and the batch gets
    `metas` (`ori_shape`, `ratio_pad`) per image."""
    imgs = np.empty((len(items), imgsz, imgsz, 3), np.uint8)
    boxes, metas = [], []
    for j, it in enumerate(items):
        img, bb = it["img"], it["boxes"]
        if not train:
            img, ratio, pad = letterbox(img, (imgsz, imgsz))
            if len(bb):
                bb = bb.copy()
                bb[:, [0, 2]] = bb[:, [0, 2]] * ratio[0] + pad[0]
                bb[:, [1, 3]] = bb[:, [1, 3]] * ratio[1] + pad[1]
            metas.append({"ori_shape": it.get("ori_shape", it["img"].shape[:2]),
                          "ratio_pad": (ratio, pad)})
        imgs[j] = img[..., ::-1]  # BGR -> RGB, stays uint8
        boxes.append(bb)
    gt_labels, gt_bboxes, mask_gt = pad_boxes(boxes, [it["cls"] for it in items], max_gt)
    out = {"img": imgs, "gt_labels": gt_labels, "gt_bboxes": gt_bboxes, "mask_gt": mask_gt}
    if not train:
        out["metas"] = metas
    return out


def collate_raw(items, imgsz: int, max_gt: int) -> Dict[str, np.ndarray]:
    """Device-augment ingest: top-left-anchored uint8 RGB squares padded
    with 114, each item's content (h, w) as `img_hw`, and unaugmented pixel
    labels."""
    b = len(items)
    imgs = np.full((b, imgsz, imgsz, 3), PAD_VALUE, np.uint8)
    hw = np.zeros((b, 2), np.float32)
    for j, it in enumerate(items):
        img = it["img"]
        h, w = img.shape[:2]
        if h > imgsz or w > imgsz:
            raise ValueError(f"a {w}x{h} item does not fit {imgsz}: resizing to the "
                             "train size is not ported")
        imgs[j, :h, :w] = img[..., ::-1]  # BGR -> RGB
        hw[j] = (h, w)
    gt_labels, gt_bboxes, mask_gt = pad_boxes([it["boxes"] for it in items],
                                              [it["cls"] for it in items], max_gt)
    return {"img": imgs, "img_hw": hw, "gt_labels": gt_labels, "gt_bboxes": gt_bboxes,
            "mask_gt": mask_gt}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated batch as tensors on `device` (`metas` stays as it is)."""
    return {k: v if k == "metas" else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


class DataLoader:
    """Seeded loader, as the JAX loader orders and pads its batches.

    Training (`train=True`): a per-epoch shuffle (`seed + epoch`), short
    batches dropped, targets padded to `max_gt = ceil(4 * max_labels / 8) *
    8`, the room of a 4-image mosaic; `device_augment=True` ships raw
    batches (`collate_raw`) for the trainer to augment on the device.
    Validation (`train=False`): dataset order, the short last batch kept,
    `max_gt = ceil(max_labels / 8) * 8`, letterboxed batches with `metas`.
    """

    def __init__(self, dataset, batch_size: int, imgsz: int, seed: int = 0,
                 train: bool = True, device_augment: bool = False):
        self.dataset, self.batch_size, self.imgsz = dataset, batch_size, imgsz
        self.seed, self.epoch, self.train = seed, 0, train
        self.device_augment = device_augment and train
        merge = 4 if train else 1
        self.max_gt = int(math.ceil(max(1, dataset.max_labels()) * merge / 8) * 8)

    def __len__(self) -> int:
        n = len(self.dataset) / self.batch_size
        return int(n) if self.train else math.ceil(n)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = list(range(len(self.dataset)))
        if self.train:
            random.Random(self.seed + self.epoch).shuffle(idx)
        for k in range(len(self)):
            items = [self.dataset[i] for i in idx[k * self.batch_size:(k + 1) * self.batch_size]]
            if self.device_augment:
                yield collate_raw(items, self.imgsz, self.max_gt)
            else:
                yield collate(items, self.imgsz, self.max_gt, self.train)
