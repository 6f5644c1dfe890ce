"""Batches: padded targets and a seeded, prefetching loader, the
counterparts of `collate`, `collate_raw` and `DataLoader` in
`mgdt_yolo_tpu/data/build.py`.

Three kinds of batch, as the JAX loader makes them:

* train, `device_augment=False`: square items already at the train size,
  stacked unaugmented (`collate`);
* train, `device_augment=True`: raw top-left-anchored uint8 squares with
  their content size `img_hw` and unaugmented labels (`collate_raw`); the
  trainer augments them on the device (`ops/device_augment.py`);
* validation (`train=False`): each item letterboxed to the square
  (`data.augment.letterbox`, `scaleup=False`), with `metas` holding the
  `ratio_pad` that maps boxes back.

Train items are first resized so their long side is the train size
(`resize_long_side`), as JAX's `_make_item` does. A dataset of image files
(`YOLODataset`) without a cache is ingested, in the device-augment case,
by the decoder's threaded `load_batch` (decode, resize, paste in C++); the
images it declines are redone through the item path, as JAX redoes them.
A producer thread keeps two batches in flight ahead of the consumer.
"""
from __future__ import annotations

import math
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from . import augment
from .augment import resize_long_side

PAD_VALUE = 114


def letterbox(img: np.ndarray, new_shape=(640, 640)):
    """The validation letterbox: `data.augment.letterbox` with
    `scaleup=False`, as the JAX `collate` calls it: an image that fits is
    centred by padding only, a larger one shrunk first (cv2's
    INTER_LINEAR). Returns (img, ratio, (dw, dh))."""
    return augment.letterbox(img, new_shape, scaleup=False)


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


def collate(items, imgsz: int, max_gt: int, train: bool = True) -> Dict[str, np.ndarray]:
    """Stack items into one batch: `img` (b, imgsz, imgsz, 3) uint8 RGB and
    the targets of `pad_boxes`. Train items must already be square at
    `imgsz`; validation items are letterboxed (`scaleup=False`) and the
    batch gets `metas` (`ori_shape`, `ratio_pad`, `path`) per image."""
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
                          "ratio_pad": (ratio, pad), "path": it.get("path", "")})
        elif img.shape[:2] != (imgsz, imgsz):
            raise ValueError(f"a {img.shape[1]}x{img.shape[0]} train item is not an {imgsz} "
                             "square: unaugmented training takes square items (the host "
                             "augmentation pipeline that places others is not ported); "
                             "use device_augment=True")
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
    labels. Items must fit the square (the loader resizes them first)."""
    b = len(items)
    imgs = np.full((b, imgsz, imgsz, 3), PAD_VALUE, np.uint8)
    hw = np.zeros((b, 2), np.float32)
    for j, it in enumerate(items):
        img = it["img"]
        h, w = img.shape[:2]
        if h > imgsz or w > imgsz:
            raise ValueError(f"a {w}x{h} item does not fit {imgsz}")
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
    batches dropped, items resized to the train size on their long side,
    targets padded to `max_gt = ceil(max_labels * merge / 8) * 8`, where
    `merge` is the room of the merges `hyp` asks for (4 for a mosaic, 9 for
    `mosaic9`, one more for `mixup`); `device_augment=True` ships raw
    batches (`collate_raw`) for the trainer to augment on the device.
    Validation (`train=False`): dataset order, the short last batch kept,
    `merge` 1, letterboxed batches with `metas`. `workers` threads make the
    items (or decode a batch in C++), two batches ahead.
    """

    def __init__(self, dataset, batch_size: int, imgsz: int, seed: int = 0,
                 train: bool = True, device_augment: bool = False,
                 hyp: Optional[Dict] = None, workers: int = 4):
        self.dataset, self.batch_size, self.imgsz = dataset, batch_size, imgsz
        self.seed, self.epoch, self.train = seed, 0, train
        self.device_augment = device_augment and train
        self.workers = max(1, workers)
        hyp = hyp or {}
        merge = 1
        if train:
            merge = (9 if hyp.get("mosaic9", 0) else 4) + (1 if hyp.get("mixup", 0) else 0)
        self.max_gt = int(math.ceil(max(1, dataset.max_labels()) * merge / 8) * 8)

    def __len__(self) -> int:
        n = len(self.dataset) / self.batch_size
        return int(n) if self.train else math.ceil(n)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.train:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx

    def _make_item(self, i: int) -> Dict:
        item = self.dataset[i]
        if self.train:
            item = resize_long_side(item, self.imgsz)
        return item

    def _collate(self, items) -> Dict[str, np.ndarray]:
        if self.device_augment:
            return collate_raw(items, self.imgsz, self.max_gt)
        return collate(items, self.imgsz, self.max_gt, self.train)

    def native_eligible(self) -> bool:
        """Whether batches go through the decoder's `load_batch`: device
        augment, image files with their labels, no cache in between."""
        ds = self.dataset
        return bool(self.device_augment and getattr(ds, "im_files", None)
                    and getattr(ds, "labels", None) is not None
                    and not getattr(ds, "cache", False))

    def _native_batch(self, chunk) -> Dict[str, np.ndarray]:
        """The `collate_raw` batch of `chunk` by the decoder's `load_batch`,
        labels scaled to each pasted size; a declined image (EXIF-rotated,
        CMYK, unreadable) is redone through the item path."""
        from ..native import OK, load_batch
        ds = self.dataset
        imgs, hw, status = load_batch([ds.im_files[i] for i in chunk], self.imgsz,
                                      PAD_VALUE, self.workers)
        single_cls = getattr(ds, "single_cls", False)
        boxes, cls = [], []
        for j, i in enumerate(chunk):
            if status[j] != OK:
                it = self._make_item(i)
                im = it["img"]
                h, w = im.shape[:2]
                imgs[j] = PAD_VALUE
                imgs[j, :h, :w] = im[..., ::-1]
                hw[j] = (h, w)
                boxes.append(it["boxes"])
                cls.append(it["cls"])
                continue
            lab = ds.labels[i]  # (n, 5): cls, cx, cy, w, h normalized
            dh, dw = hw[j]
            cx, cy = lab[:, 1] * dw, lab[:, 2] * dh
            bw, bh = lab[:, 3] * dw, lab[:, 4] * dh
            boxes.append(np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1))
            cls.append(np.zeros(len(lab), np.float32) if single_cls else lab[:, 0])
        gt_labels, gt_bboxes, mask_gt = pad_boxes(boxes, cls, self.max_gt)
        return {"img": imgs, "img_hw": hw, "gt_labels": gt_labels, "gt_bboxes": gt_bboxes,
                "mask_gt": mask_gt}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        nb, bs = len(self), self.batch_size
        chunks = [idx[k * bs:(k + 1) * bs] for k in range(nb)]
        native = self.native_eligible()
        # the native path: whole batches, two at a time; the item path: the
        # items of the two batches in flight on `workers` threads
        pool = ThreadPoolExecutor(2 if native else self.workers,
                                  thread_name_prefix="mgdt-data")
        q: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()

        def submit(k):
            if native:
                return pool.submit(self._native_batch, chunks[k])
            return [pool.submit(self._make_item, i) for i in chunks[k]]

        def result(pending):
            if native:
                return pending.result()
            return self._collate([f.result() for f in pending])

        def put(item) -> bool:
            # a consumer that leaves mid-epoch sets `stop`; without it the
            # producer would block on the full queue for good
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                pending: deque = deque(submit(k) for k in range(min(2, nb)))
                nxt = len(pending)
                while pending:
                    batch = result(pending.popleft())
                    if nxt < nb:
                        pending.append(submit(nxt))
                        nxt += 1
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # surfaced to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True, name="mgdt-loader")
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
