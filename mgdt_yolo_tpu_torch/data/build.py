"""Batches: padded targets and a seeded, prefetching loader, the
counterparts of `collate`, `collate_raw` and `DataLoader` in
`mgdt_yolo_tpu/data/build.py`.

Three kinds of batch, as the JAX loader makes them:

* train, `device_augment=False` (the JAX default): each item through the
  host augmentation pipeline (`data.augment.train_transform`) to an
  imgsz square, then stacked (`collate`);
* train, `device_augment=True`: raw top-left-anchored uint8 squares with
  their content size `img_hw` and unaugmented labels (`collate_raw`); the
  trainer augments them on the device (`ops/device_augment.py`);
* validation (`train=False`): each item letterboxed to the square
  (`data.augment.letterbox`, `scaleup=False`), with `metas` holding the
  `ratio_pad` that maps boxes back; with `rect`, the images ordered by
  aspect and each batch letterboxed to its own stride-aligned (h, w), the
  JAX loader's rectangular plan (`_set_rectangle`).

Train items are first resized so their long side is the train size
(`resize_long_side`), as JAX's `_make_item` does. On the host path the
item at epoch position p is transformed with a `random.Random` seeded
`(seed * 1000003 + epoch * 7919 + p) & 0x7FFFFFFF` and the dataset's
`buffer`: the last 32 resized items before it, kept across epochs, from
which the mosaic and mixup draw their partners. The JAX loader fills that
buffer as its threads finish, so its batches depend on their timing unless
`workers=1`; here the buffer of each position is the one JAX's `workers=1`
gives, whatever the thread count: items are decoded ahead in parallel, each
transform is handed the buffer of its position, and the transforms run in
parallel. A dataset of image files (`YOLODataset`) without a cache is
ingested, in the device-augment case, by the decoder's threaded
`load_batch` (decode, resize, paste in C++); the images it declines are
redone through the item path, as JAX redoes them. A producer thread keeps
two batches in flight ahead of the consumer.
"""
from __future__ import annotations

import math
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from . import augment, imgproc
from .augment import resize_long_side, train_transform

PAD_VALUE = 114
BUFFER_SIZE = 32   # the JAX dataset's mosaic/mixup buffer


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


def collate(items, imgsz, max_gt: int, train: bool = True,
            mask_ratio: int = 4) -> Dict[str, np.ndarray]:
    """Stack items into one batch: `img` (b, h, w, 3) uint8 RGB and the
    targets of `pad_boxes`; `imgsz` is an int (a square) or an (h, w) pair
    (a rectangular validation batch). Train items are the host pipeline's
    `imgsz` squares; validation items are letterboxed (`scaleup=False`) and
    the batch gets `metas` (`ori_shape`, `ratio_pad`, `path`) per image.
    Items of the segment and pose tasks add, as JAX's `collate` does,
    `masks` (b, max_gt, h // mask_ratio, w // mask_ratio) float32, each
    kept object's mask resized nearest (not letterboxed), and `keypoints`
    (b, max_gt, k, 3), shaped by the first item that has any objects;
    a batch whose items with keypoints hold no object gets none."""
    th, tw = (imgsz, imgsz) if isinstance(imgsz, int) else (int(imgsz[0]), int(imgsz[1]))
    imgs = np.empty((len(items), th, tw, 3), np.uint8)
    boxes, metas = [], []
    for j, it in enumerate(items):
        img, bb = it["img"], it["boxes"]
        if not train:
            img, ratio, pad = letterbox(img, (th, tw))
            if len(bb):
                bb = bb.copy()
                bb[:, [0, 2]] = bb[:, [0, 2]] * ratio[0] + pad[0]
                bb[:, [1, 3]] = bb[:, [1, 3]] * ratio[1] + pad[1]
            metas.append({"ori_shape": it.get("ori_shape", it["img"].shape[:2]),
                          "ratio_pad": (ratio, pad), "path": it.get("path", "")})
        imgs[j] = img[..., ::-1]  # BGR -> RGB, stays uint8
        boxes.append(bb)
    gt_labels, gt_bboxes, mask_gt = pad_boxes(boxes, [it["cls"] for it in items], max_gt)
    out = {"img": imgs, "gt_labels": gt_labels, "gt_bboxes": gt_bboxes, "mask_gt": mask_gt}
    out.update(instance_planes(items, (th, tw), max_gt, mask_ratio))
    if not train:
        out["metas"] = metas
    return out


def instance_planes(items, shape, max_gt: int, mask_ratio: int = 4) -> Dict[str, np.ndarray]:
    """`collate`'s per-object planes of the items that carry `masks` or
    `keypoints` (see there); {} for detect items."""
    b, (th, tw) = len(items), shape
    out, kpts = {}, None
    if any("masks" in it for it in items):
        mh, mw = th // mask_ratio, tw // mask_ratio
        out["masks"] = np.zeros((b, max_gt, mh, mw), np.float32)
    for j, it in enumerate(items):
        n = min(len(it["boxes"]), max_gt)
        if not n:
            continue
        if "masks" in out and "masks" in it:
            for k in range(n):
                out["masks"][j, k] = imgproc.resize_nearest(it["masks"][k], (mw, mh))
        if "keypoints" in it:
            kp = it["keypoints"]
            if kpts is None:
                kpts = np.zeros((b, max_gt, kp.shape[1], kp.shape[2]), np.float32)
            kpts[j, :n] = kp[:n]
    if kpts is not None:
        out["keypoints"] = kpts
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
    `mosaic9`, one more for `mixup`); the items go through the host
    pipeline with `hyp` (the keys of `cfg/default.py`, which a `Trainer`
    gives a loader built without them; iterating the host path with none
    raises), or, with `device_augment=True`, raw batches
    (`collate_raw`) are shipped for the trainer to augment on the device.
    Validation (`train=False`): dataset order, the short last batch kept,
    `merge` 1, letterboxed batches with `metas`; with `rect`, the order by
    aspect and each batch's shape in `batch_shapes` (`stride`, as JAX's
    validator passes it, the model's largest stride).
    `workers` threads make the items (or decode a batch in C++), two
    batches ahead.
    """

    def __init__(self, dataset, batch_size: int, imgsz: int, seed: int = 0,
                 train: bool = True, device_augment: bool = False,
                 hyp: Optional[Dict] = None, workers: int = 4, rect: bool = False,
                 stride: int = 32):
        self.dataset, self.batch_size, self.imgsz = dataset, batch_size, imgsz
        self.seed, self.epoch, self.train = seed, 0, train
        self.device_augment = device_augment and train
        self.workers = max(1, workers)
        self.set_hyp(hyp)
        # the mosaic/mixup buffer: the dataset's, as JAX keeps it there
        self.buffer = getattr(dataset, "buffer", None)
        if self.buffer is None:
            self.buffer = []
        self.rect = rect and not train
        self.batch_shapes = None
        if self.rect:
            self._set_rectangle(stride)

    def set_hyp(self, hyp: Optional[Mapping]) -> None:
        """Take `hyp` and size `max_gt` for the merges it asks for (None:
        a mosaic of 4, as the JAX loader sizes it)."""
        self.hyp = hyp
        h, merge = hyp or {}, 1
        if self.train:
            merge = (9 if h.get("mosaic9", 0) else 4) + (1 if h.get("mixup", 0) else 0)
        self.max_gt = int(math.ceil(max(1, self.dataset.max_labels()) * merge / 8) * 8)

    def _set_rectangle(self, stride: int):
        """The JAX loader's plan: images sorted by aspect (h / w), and per
        batch the shape `ceil(shape * imgsz / stride + 0.5) * stride` (the
        pad of 0.5 JAX's validator passes), where
        shape is (max aspect, 1) for a batch of landscapes, (1, 1 / min
        aspect) for portraits, else square."""
        s = np.array(self.dataset.shapes(), float)
        ar = s[:, 0] / s[:, 1]
        self._rect_order = np.argsort(ar).tolist()
        ar = ar[self._rect_order]
        bs, shapes = self.batch_size, []
        for i in range(len(self)):
            ari = ar[i * bs:(i + 1) * bs]
            mini, maxi = ari.min(), ari.max()
            shape = [1.0, 1.0]
            if maxi < 1:
                shape = [maxi, 1.0]
            elif mini > 1:
                shape = [1.0, 1.0 / mini]
            shapes.append(shape)
        self.batch_shapes = (np.ceil(np.array(shapes) * self.imgsz / stride + 0.5)
                             .astype(int) * stride)

    def __len__(self) -> int:
        n = len(self.dataset) / self.batch_size
        return int(n) if self.train else math.ceil(n)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        if self.rect:
            return list(self._rect_order)
        idx = list(range(len(self.dataset)))
        if self.train:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx

    def _make_item(self, i: int) -> Dict:
        item = self.dataset[i]
        if self.train:
            item = resize_long_side(item, self.imgsz)
        return item

    @property
    def host_augment(self) -> bool:
        """Whether the train items go through the host pipeline."""
        return self.train and not self.device_augment

    def _transform(self, item: Dict, picks: List[Dict], pos: int, epoch: int) -> Dict:
        """`train_transform` of the item at epoch position `pos` with the
        buffer `picks`, its rng seeded as the JAX loader seeds it."""
        rng = random.Random((self.seed * 1000003 + epoch * 7919 + pos) & 0x7FFFFFFF)
        return train_transform(item, self.imgsz, self.hyp, picks, rng,
                               flip_idx=getattr(self.dataset, "flip_idx", None))

    def _schedule(self, pool, items, k: int, epoch: int):
        """Hand the transforms of batch `k` to the pool, in epoch order:
        each item gets the buffer of its position, then joins it. `items`
        are the futures of its resized items."""
        futs = []
        for j, f in enumerate(items):
            item = f.result()
            futs.append(pool.submit(self._transform, item, list(self.buffer),
                                    k * self.batch_size + j, epoch))
            self.buffer.append(item)
            if len(self.buffer) > BUFFER_SIZE:
                self.buffer.pop(0)
        return futs

    def _collate(self, items, k: int) -> Dict[str, np.ndarray]:
        """Batch `k` of the epoch from its items."""
        if self.device_augment:
            return collate_raw(items, self.imgsz, self.max_gt)
        shape = tuple(self.batch_shapes[k]) if self.rect else self.imgsz
        return collate(items, shape, self.max_gt, self.train)

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

    def first_batch(self) -> Dict[str, np.ndarray]:
        """Batch 0 of the epoch, made at once, as JAX's trainer draws one
        from its loader for `train_batch0.jpg` before training: on the host
        path its items, and no others, join the buffer (what JAX's
        `workers=1` loader gives when its iterator is closed at once)."""
        if self.host_augment and self.hyp is None:
            raise ValueError("a host-path train loader needs `hyp`")
        if len(self) == 0:
            raise ValueError("the loader has no batch")
        chunk = self._indices()[:self.batch_size]
        if self.native_eligible():
            return self._native_batch(chunk)
        with ThreadPoolExecutor(self.workers, thread_name_prefix="mgdt-data") as pool:
            items = [pool.submit(self._make_item, i) for i in chunk]
            if self.host_augment:
                items = self._schedule(pool, items, 0, self.epoch)
            return self._collate([f.result() for f in items], 0)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.host_augment and self.hyp is None:
            raise ValueError("a host-path train loader needs `hyp`: build it with hyp=..., or "
                             "hand it to a Trainer, which gives it its arguments")
        idx = self._indices()
        nb, bs = len(self), self.batch_size
        chunks = [idx[k * bs:(k + 1) * bs] for k in range(nb)]
        native, host, epoch = self.native_eligible(), self.host_augment, self.epoch
        # the native path: whole batches, two at a time; the item path: the
        # items of the two batches in flight on `workers` threads, and on
        # the host path their transforms, scheduled in epoch order
        pool = ThreadPoolExecutor(2 if native else self.workers,
                                  thread_name_prefix="mgdt-data")
        q: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()
        pending: deque = deque()      # the batches in flight, in order
        ahead: Dict[int, list] = {}   # host path: transforms handed out ahead

        def submit(k):
            if native:
                return pool.submit(self._native_batch, chunks[k])
            return [pool.submit(self._make_item, i) for i in chunks[k]]

        def result(items, k):
            if native:
                return items.result()
            if host:
                # this batch's transforms, and the next one's, so the pool
                # has work while this batch's last items finish
                items = ahead.pop(k, None) or self._schedule(pool, items, k, epoch)
                if pending:
                    ahead[k + 1] = self._schedule(pool, pending[0], k + 1, epoch)
            return self._collate([f.result() for f in items], k)

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
                pending.extend(submit(k) for k in range(min(2, nb)))
                nxt, done = len(pending), 0
                while pending:
                    batch = result(pending.popleft(), done)
                    done += 1
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
