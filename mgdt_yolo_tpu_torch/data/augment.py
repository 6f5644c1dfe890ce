"""The host augmentation pipeline and the letterbox, without cv2.

Counterparts of the JAX package's `mgdt_yolo_tpu/data/augment.py`, each by
name: `letterbox`, `resize_long_side`, `augment_hsv`, `box_candidates`,
`random_perspective`, `mosaic4`, `mosaic9`, `bbox_ioa`, `copy_paste`,
`Albumentations` (its native path), `mixup` and `train_transform`, the
pipeline the JAX trainer runs with its default `device_augment=False`:
mosaic (4 or 9 tiles), the affine or perspective warp, mixup,
Albumentations' four p=0.01 filters, the HSV jitter and the flips. Every
random draw is the JAX function's, in its order and on the same
`random.Random`, so the same seed gives the same boxes, classes and rng
state; the pixels come from `data/imgproc.py`, cv2's arithmetic in numpy.
Items of the segment and pose tasks carry per-instance `masks` (n, H, W)
float32 and `keypoints` (n, k, 3) through every geometric step as JAX's
do: the masks warped by the same matrix (cv2's bilinear float32 warp),
resized nearest, placed in the mosaic planes and flipped; the keypoints
mapped, their visibility cleared outside the frame, flipped with
`flip_idx`; mixup and Albumentations skip such items, as in JAX. The JAX
`Albumentations` hands its work to the `albumentations` package where that
imports; the port always takes the native path.

`resize_linear` computes cv2's 8-bit bilinear resize in numpy, by cv2's
own fixed-point recipe:

1. each output column's source coordinate `(i + 0.5) * (src / dst) - 0.5`
   in float32 (the scale a double, as cv2 takes it: `1 / (dst / src)`),
   its floor the first tap and the rest `f`; a column left of the first
   pixel or at or past the last one takes that edge pixel whole, a row
   there reads the edge row for both taps;
2. the taps' weights `rint((1 - f) * 2048)` and `rint(f * 2048)`;
3. a horizontal pass in integers, the same for the rows;
4. a vertical pass as cv2's vector code rounds it:
   `(((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2`;
5. at a down-ratio of exactly 2 on both axes, cv2's INTER_AREA fast path
   instead: the rounded mean of each 2x2 block.

It gave cv2 5.0.0's bits on every shape of its tests and on 300 random
ones. cv2's scalar code for the last few values of a row rounds as
`(b0 * S0 + b1 * S1 + 2^21) >> 22`, which can differ from the vector form
by one grey level, so the tests allow that where the ratio is not an
integer (`tests/test_torch_letterbox.py`).
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from . import imgproc

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # cv2's INTER_RESIZE_COEF_SCALE


def _taps(src: int, dst: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis: the two source indices of
    each output index and their fixed-point weights. Columns past an edge
    take the edge pixel with weight 1 (`clamp`); rows keep their weights on
    the edge row read twice, as cv2 does."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        f[(s < 0) | (s >= src - 1)] = 0.0
    w0 = np.rint((np.float32(1.0) - f) * np.float32(COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _area_fast(img: np.ndarray) -> np.ndarray:
    """cv2's INTER_AREA fast path at a down-ratio of 2: the rounded mean of
    each 2x2 block."""
    h, w, c = img.shape
    rows = img.reshape(h // 2, 2, w * c)
    r = rows[:, 0].astype(np.uint16)
    r += rows[:, 1]  # each pair of rows summed, then each pair of columns
    r = r.reshape(h // 2, w // 2, 2, c)
    s = r[:, :, 0] + r[:, :, 1]
    s += 2
    s >>= 2
    return s.astype(np.uint8)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)` for an
    (h, w, c) uint8 image; `size` is (width, height), as cv2 takes it."""
    dw, dh = size
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img)
    if (dw, dh) == (w, h):
        return img.copy()
    sx, sy = 1.0 / (dw / w), 1.0 / (dh / h)
    if sx == 2.0 and sy == 2.0:  # cv2 takes INTER_AREA's fast path here
        return _area_fast(img)
    c = img.shape[2]
    x0, x1, a0, a1 = _taps(w, dw, clamp=True)
    y0, y1, b0, b1 = _taps(h, dh, clamp=False)
    # a second tap of weight 0 on every row or column adds 0: skip it
    two_x, two_y = bool(a1.any()), bool(b1.any())
    # the horizontal pass, in cv2's integers, on the rows the vertical pass
    # reads, each row flat as (w * c) so one gather takes every channel
    rows, inv = np.unique(np.concatenate([y0, y1] if two_y else [y0]), return_inverse=True)
    src = img.reshape(h, w * c)[rows]
    ch = np.arange(c)
    hp = np.take(src, (x0[:, None] * c + ch).ravel(), axis=1).astype(np.int32)
    hp *= np.repeat(a0, c)
    if two_x:
        hp1 = np.take(src, (x1[:, None] * c + ch).ravel(), axis=1).astype(np.int32)
        hp1 *= np.repeat(a1, c)
        hp += hp1
    hp >>= 4
    out = (b0[:, None] * hp[inv[:dh]]) >> 16
    if two_y:
        out += (b1[:, None] * hp[inv[dh:]]) >> 16
    out += 2
    out >>= 2
    return out.astype(np.uint8).reshape(dh, dw, c)


def letterbox(img: np.ndarray, new_shape=(640, 640), color=(114, 114, 114),
              auto: bool = False, scale_fill: bool = False, scaleup: bool = True,
              stride: int = 32):
    """Resize `img` (h, w, 3) uint8 keeping its aspect, then pad it with
    `color` to `new_shape` (h, w; an int for a square), as the JAX
    `letterbox` does: the reference's +-0.1 rounding of the two pads, `auto`
    padding only to a multiple of `stride`, `scale_fill` stretching to the
    shape, `scaleup=False` never enlarging. Returns (img, ratio (rw, rh),
    (dw, dh)), the pads before their rounding."""
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        img = resize_linear(img, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.empty((img.shape[0] + top + bottom, img.shape[1] + left + right, img.shape[2]),
                   np.uint8)
    out[...] = np.asarray(color, np.uint8)
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out, ratio, (dw, dh)


def resize_long_side(item: Dict, imgsz: int) -> Dict:
    """An item (`img` BGR uint8, `boxes` xyxy pixels, `cls`, optional
    `masks` and `keypoints`) resized so its long side is `imgsz`, labels
    scaled with it, as the JAX `resize_long_side(augment=True)` does before
    augmentation (the JAX loader's only call): r = imgsz / max(h, w), the
    new sides min(ceil(side * r), imgsz), cv2's INTER_LINEAR
    (`resize_linear`), the masks INTER_NEAREST."""
    img = item["img"]
    h0, w0 = img.shape[:2]
    r = imgsz / max(h0, w0)
    if r == 1:
        return item
    w = min(math.ceil(w0 * r), imgsz)
    h = min(math.ceil(h0 * r), imgsz)
    out = dict(item, img=resize_linear(img, (w, h)))
    if len(item.get("boxes", ())):
        boxes = item["boxes"].copy()
        boxes[:, [0, 2]] *= w / w0
        boxes[:, [1, 3]] *= h / h0
        out["boxes"] = boxes
    if "keypoints" in item:
        kp = item["keypoints"].copy()
        kp[..., 0] *= w / w0
        kp[..., 1] *= h / h0
        out["keypoints"] = kp
    if "masks" in item and len(item["masks"]):
        out["masks"] = np.stack([imgproc.resize_nearest(m, (w, h)) for m in item["masks"]])
    return out


PAD = (114, 114, 114)
TASK_KEYS = ("masks", "keypoints")


def warp_masks(masks: np.ndarray, M: np.ndarray, dsize, perspective: bool) -> np.ndarray:
    """Per-instance float32 masks (n, H, W) warped by `M` onto `dsize` (w,
    h) with a border of 0, as JAX warps each with cv2. Each plane is
    computed only where it can be nonzero: over the output box of its
    nonzero source extent grown by the bilinear reach (1 px) and 2 px for
    the rounding of the inverse matrix; every other output pixel's four taps
    are 0, so it is 0 in the whole warp too (a perspective whose horizon
    crosses that extent is computed whole)."""
    w, h = dsize
    out = np.zeros((len(masks), h, w), np.float32)
    for k, m in enumerate(masks):
        rows = np.flatnonzero(m.any(1))
        if not rows.size:
            continue
        cols = np.flatnonzero(m.any(0))
        corners = np.array([[cols[0] - 1, rows[0] - 1, 1], [cols[-1] + 1, rows[0] - 1, 1],
                            [cols[0] - 1, rows[-1] + 1, 1], [cols[-1] + 1, rows[-1] + 1, 1]],
                           np.float64) @ M.T
        region = None
        if not perspective or (corners[:, 2] > 0).all():
            xy = corners[:, :2] / corners[:, 2:] if perspective else corners[:, :2]
            x0, y0 = (max(int(math.floor(v)) - 2, 0) for v in xy.min(0))
            x1, y1 = (int(math.ceil(v)) + 3 for v in xy.max(0))
            region = (x0, y0, min(max(x1, x0), w), min(max(y1, y0), h))
            if region[0] >= region[2] or region[1] >= region[3]:
                continue
        plane = m.astype(np.float32)
        out[k] = (imgproc.warp_perspective(plane, M, dsize, (0.0,), region=region)
                  if perspective else
                  imgproc.warp_affine(plane, M[:2], dsize, (0.0,), region=region))
    return out


def augment_hsv(img: np.ndarray, hgain: float = 0.015, sgain: float = 0.7,
                vgain: float = 0.4, rng: Optional[random.Random] = None) -> np.ndarray:
    """The HSV jitter through per-channel LUTs, as the JAX `augment_hsv`:
    three uniform(-1, 1) gains drawn whenever any gain is set. BGR uint8."""
    rng = rng or random
    if hgain or sgain or vgain:
        r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(np.uint8)
        lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
        lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
        img = imgproc.hsv_luts(img, lut_hue, lut_sat, lut_val)
    return img


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2,
                   ar_thr: float = 100, area_thr: float = 0.1,
                   eps: float = 1e-16) -> np.ndarray:
    """The boxes that survived the warp: wider and taller than `wh_thr`
    pixels, above `area_thr` of their area before it, aspect below
    `ar_thr`. Boxes as (4, n) columns."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr) &
            (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def random_perspective(img: np.ndarray, boxes_xyxy: np.ndarray, cls: np.ndarray,
                       degrees: float = 0.0, translate: float = 0.1,
                       scale: float = 0.5, shear: float = 0.0,
                       perspective: float = 0.0,
                       border: Tuple[int, int] = (0, 0),
                       rng: Optional[random.Random] = None,
                       masks: Optional[np.ndarray] = None,
                       keypoints: Optional[np.ndarray] = None):
    """The JAX `random_perspective`: the matrix
    M = T @ S @ R @ P @ C from its draws (in double, bit for bit JAX's),
    the image warped by it (affine, or perspective where `perspective` is
    set; skipped where M is the identity and there is no border) onto
    (h, w) = the image's size plus twice `border`, the boxes' corners
    mapped, clipped, and kept by `box_candidates` (at 0.01 of their area
    where masks ride, else 0.1). `masks` (n, H, W) are warped by the same
    matrix (`warp_masks`), `keypoints` (n, k, 3) mapped with their
    visibility cleared outside the output. Returns (img, boxes, cls,
    extras), extras holding the `masks` and `keypoints` given."""
    rng = rng or random
    h = img.shape[0] + border[0] * 2
    w = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = imgproc.rotation_matrix_2d((0, 0), a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = imgproc.warp_perspective(img, M, (w, h), PAD)
        else:
            img = imgproc.warp_affine(img, M[:2], (w, h), PAD)

    n = len(boxes_xyxy)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes_xyxy[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        keep = box_candidates(boxes_xyxy.T * s, new.T,
                              area_thr=0.01 if masks is not None and len(masks) else 0.1)
        boxes_xyxy = new[keep]
        cls = cls[keep]
        if masks is not None and len(masks):
            masks = warp_masks(masks, M, (w, h), bool(perspective))[keep]
        if keypoints is not None and len(keypoints):
            nk = keypoints.shape[1]
            pts = np.ones((n * nk, 3))
            pts[:, :2] = keypoints[..., :2].reshape(n * nk, 2)
            pts = pts @ M.T
            pxy = (pts[:, :2] / pts[:, 2:3] if perspective else pts[:, :2]).reshape(n, nk, 2)
            inside = ((pxy[..., 0] >= 0) & (pxy[..., 0] < w) &
                      (pxy[..., 1] >= 0) & (pxy[..., 1] < h))
            vis = np.where(inside, keypoints[..., 2], 0.0)
            keypoints = np.concatenate([pxy, vis[..., None]], -1)[keep]
    extras = {}
    if masks is not None:
        extras["masks"] = masks
    if keypoints is not None:
        extras["keypoints"] = keypoints
    return img, boxes_xyxy, cls, extras


def _merge(all_boxes, all_cls):
    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
    cls = np.concatenate(all_cls) if all_cls else np.zeros((0,), np.float32)
    return boxes, cls


def _tile_planes(items, item, n: int, size: int, dst, src, shift, with_masks: bool,
                 with_kpts: bool):
    """The mosaic planes of one tile's `n` objects: masks on a (size, size)
    canvas, its `src` window (y1, y2, x1, x2) of the item's planes at `dst`,
    and keypoints shifted by `shift` (padw, padh); a box-only tile of a
    keypoint mosaic gets all-invisible slots of the others' count. Returns
    (masks or None, keypoints or None)."""
    planes = kpts = None
    if with_masks:
        planes = np.zeros((n, size, size), np.float32)
        if "masks" in item and len(item["masks"]):
            (ya, yb, xa, xb), (y1, y2, x1, x2) = dst, src
            planes[:, ya:yb, xa:xb] = item["masks"][:n, y1:y2, x1:x2]
    if with_kpts:
        if "keypoints" in item and len(item["keypoints"]):
            kpts = item["keypoints"].copy()
            kpts[..., 0] += shift[0]
            kpts[..., 1] += shift[1]
        else:
            nk = next(it["keypoints"].shape[1] for it in items if "keypoints" in it)
            kpts = np.zeros((n, nk, 3), np.float32)
    return planes, kpts


def _extras(with_masks, with_kpts, all_masks, all_kpts, size: int) -> Dict:
    extras = {}
    if with_masks:
        extras["masks"] = (np.concatenate(all_masks) if all_masks
                           else np.zeros((0, size, size), np.float32))
    if with_kpts:
        extras["keypoints"] = (np.concatenate(all_kpts) if all_kpts
                               else np.zeros((0, 17, 3), np.float32))
    return extras


def mosaic4(items: List[Dict], imgsz: int, rng: Optional[random.Random] = None):
    """The 4-image mosaic of the JAX `mosaic4`: a (2s, 2s) canvas of 114, a
    centre drawn in [s/2, 3s/2) on each axis, each item anchored there by
    one corner (the first top-left, then top-right, bottom-left,
    bottom-right), its boxes shifted with it and clipped to the canvas, its
    masks and keypoints placed with it (`_tile_planes`). Returns (canvas,
    boxes, cls, extras); the caller crops back to s with
    `random_perspective(border=-s // 2)`."""
    rng = rng or random
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    with_masks = any("masks" in it for it in items[:4])
    with_kpts = any("keypoints" in it for it in items[:4])
    all_boxes, all_cls, all_masks, all_kpts = [], [], [], []
    for i, item in enumerate(items[:4]):
        img = item["img"]
        h, w = img.shape[:2]
        left, top = i in (0, 2), i in (0, 1)
        x1a = max(xc - w, 0) if left else xc
        x2a = xc if left else min(xc + w, 2 * s)
        y1a = max(yc - h, 0) if top else yc
        y2a = yc if top else min(yc + h, 2 * s)
        kw, kh = x2a - x1a, y2a - y1a
        x1b, x2b = (w - kw, w) if left else (0, kw)
        y1b, y2b = (h - kh, h) if top else (0, kh)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(item["boxes"]):
            b = item["boxes"].copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            all_boxes.append(b)
            all_cls.append(item["cls"])
            m, k = _tile_planes(items[:4], item, len(b), 2 * s, (y1a, y2a, x1a, x2a),
                                (y1b, y2b, x1b, x2b), (padw, padh), with_masks, with_kpts)
            all_masks += [m] if m is not None else []
            all_kpts += [k] if k is not None else []
    boxes, cls = _merge(all_boxes, all_cls)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    return canvas, boxes, cls, _extras(with_masks, with_kpts, all_masks, all_kpts, 2 * s)


def mosaic9(items: List[Dict], imgsz: int, rng: Optional[random.Random] = None):
    """The 9-image mosaic of the JAX `mosaic9`: the first item in the centre
    of a (3s, 3s) canvas, the others around it clockwise from the top, each
    placed by its neighbours' sizes, then the window [s/2, s/2 + 2s) cut
    out, so the caller's `random_perspective(border=-s // 2)` crops it as
    it crops `mosaic4`, masks and keypoints placed and cut with it. Takes no
    draw. Returns (canvas, boxes, cls, extras)."""
    s = imgsz
    img9 = np.full((s * 3, s * 3, 3), 114, dtype=np.uint8)
    with_masks = any("masks" in it for it in items[:9])
    with_kpts = any("keypoints" in it for it in items[:9])
    hp = wp = -1
    h0 = w0 = s
    all_boxes, all_cls, all_masks, all_kpts = [], [], [], []
    for i, item in enumerate(items[:9]):
        img = item["img"]
        h, w = img.shape[:2]
        if i == 0:  # centre
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:  # top
            c = s, s - h, s + w, s
        elif i == 2:  # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:  # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:  # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:  # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:  # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:  # left
            c = s - w, s + h0 - h, s, s + h0
        else:  # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padw, padh = c[:2]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        img9[y1:y2, x1:x2] = img[y1 - padh:y1 - padh + (y2 - y1),
                                 x1 - padw:x1 - padw + (x2 - x1)]
        hp, wp = h, w
        if len(item["boxes"]):
            b = item["boxes"].copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            all_boxes.append(b)
            all_cls.append(item["cls"])
            src = (y1 - padh, y1 - padh + (y2 - y1), x1 - padw, x1 - padw + (x2 - x1))
            m, k = _tile_planes(items[:9], item, len(b), 3 * s, (y1, y2, x1, x2), src,
                                (padw, padh), with_masks, with_kpts)
            all_masks += [m] if m is not None else []
            all_kpts += [k] if k is not None else []
    off = s // 2
    canvas = img9[off:off + 2 * s, off:off + 2 * s]
    boxes, cls = _merge(all_boxes, all_cls)
    boxes -= off
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    extras = _extras(with_masks, with_kpts, all_masks, all_kpts, 3 * s)
    if with_masks:
        extras["masks"] = extras["masks"][:, off:off + 2 * s, off:off + 2 * s]
    if with_kpts:
        extras["keypoints"][..., :2] -= off
    return canvas, boxes, cls, extras


def bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2's area, (n, m), for xyxy boxes."""
    ix1 = np.maximum(box1[:, None, 0], box2[None, :, 0])
    iy1 = np.maximum(box1[:, None, 1], box2[None, :, 1])
    ix2 = np.minimum(box1[:, None, 2], box2[None, :, 2])
    iy2 = np.minimum(box1[:, None, 3], box2[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area2 = ((box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]))[None]
    return inter / (area2 + eps)


def copy_paste(img: np.ndarray, boxes: np.ndarray, cls: np.ndarray,
               masks: np.ndarray, p: float = 0.5,
               rng: Optional[random.Random] = None):
    """Segment copy-paste, as the JAX `copy_paste`: of the instances whose
    left-right flipped box overlaps every box by IoA < 0.30, round(p * n)
    drawn by `rng.sample` are pasted flipped (the pixels under the flipped
    mask), their labels and masks added. It needs per-instance masks (n, H,
    W), so the pipeline reaches it only for segment items; without masks it
    returns its inputs and draws nothing."""
    rng = rng or random
    if not p or masks is None or not len(masks):
        return img, boxes, cls, masks
    h, w = img.shape[:2]
    flip_boxes = boxes.copy()
    flip_boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    ioa = bbox_ioa(flip_boxes, boxes)
    candidates = np.nonzero((ioa < 0.30).all(1))[0]
    k = round(p * len(candidates))
    if k == 0:
        return img, boxes, cls, masks
    picks = rng.sample(list(candidates), k=k)
    img = img.copy()
    flipped_img = img[:, ::-1]
    new_boxes, new_cls, new_masks = [boxes], [cls], [masks]
    for j in picks:
        fm = masks[j][:, ::-1]
        sel = fm > 0.5
        img[sel] = flipped_img[sel]
        new_boxes.append(flip_boxes[j:j + 1])
        new_cls.append(cls[j:j + 1])
        new_masks.append(fm[None])
    return (img, np.concatenate(new_boxes), np.concatenate(new_cls),
            np.concatenate(new_masks))


class Albumentations:
    """The JAX `Albumentations` on its native path: with probability `p`
    (and only for an image with labels), Blur, MedianBlur, ToGray and CLAHE,
    each at p=0.01 in that order, each with its own draw: a box filter and
    a median filter of size `rng.choice([3, 5, 7])`, grey by the RGB
    weights, and CLAHE (clip limit uniform in [1, 4), 8x8 tiles) on the L
    channel of LAB. As in JAX, ToGray and CLAHE take the BGR data as RGB.
    None of them moves a pixel, so boxes and classes pass through."""

    def __init__(self, p: float = 1.0):
        self.p = p

    @staticmethod
    def _native(img: np.ndarray, rng) -> np.ndarray:
        if rng.random() < 0.01:
            img = imgproc.box_blur(img, rng.choice([3, 5, 7]))
        if rng.random() < 0.01:
            img = imgproc.median_blur(img, rng.choice([3, 5, 7]))
        if rng.random() < 0.01:
            img = imgproc.gray_to_bgr(imgproc.rgb_to_gray(img))
        if rng.random() < 0.01:
            clip = rng.uniform(1.0, 4.0)
            lab = imgproc.rgb_to_lab(img)
            lab[:, :, 0] = imgproc.clahe(lab[:, :, 0], clip, (8, 8))
            img = imgproc.lab_to_rgb(lab)
        return img

    def __call__(self, img, boxes_xyxy, cls, rng: Optional[random.Random] = None):
        rng = rng or random
        if not len(cls) or rng.random() >= self.p:
            return img, boxes_xyxy, cls
        return self._native(img, rng), boxes_xyxy, cls


ALBUMENTATIONS = Albumentations(p=1.0)


def mixup(item_a: Dict, item_b: Dict, rng: Optional[random.Random] = None) -> Dict:
    """The JAX `mixup`: a Beta(32, 32) blend of two images of one shape (the
    ratio from numpy's generator seeded by `rng.randrange(2**31)`), with
    the union of their labels."""
    rng = rng or random
    r = np.random.default_rng(rng.randrange(2 ** 31)).beta(32.0, 32.0)
    img = (item_a["img"].astype(np.float32) * r +
           item_b["img"].astype(np.float32) * (1 - r)).astype(np.uint8)
    boxes = np.concatenate([item_a["boxes"], item_b["boxes"]])
    cls = np.concatenate([item_a["cls"], item_b["cls"]])
    return {"img": img, "boxes": boxes, "cls": cls}


def _letterboxed(item: Dict, shape) -> Tuple[np.ndarray, np.ndarray]:
    """`item`'s image letterboxed to `shape` (scaleup) and its boxes mapped."""
    img, r, (dw, dh) = letterbox(item["img"], shape, scaleup=True)
    boxes = item["boxes"].copy()
    if len(boxes):
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * r[0] + dw
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * r[1] + dh
    return img, boxes


def train_transform(item: Dict, imgsz: int, hyp: Mapping, buffer: List[Dict],
                    rng: Optional[random.Random] = None,
                    flip_idx: Optional[List[int]] = None) -> Dict:
    """The JAX `train_transform`: with probability `mosaic` (and 3 items in
    `buffer`) a mosaic of the item and items drawn from `buffer` (9 tiles
    with probability `mosaic9` and 8 in the buffer), else the item
    letterboxed to `imgsz` (its masks resized nearest into the letterbox,
    its keypoints mapped); copy-paste with probability `copy_paste` where
    masks ride; then `random_perspective` back to `imgsz` square; mixup with
    probability `mixup` (always drawn) with a letterboxed buffer item, and
    `ALBUMENTATIONS`, for detect items only; `augment_hsv`; the flips, the
    left-right one swapping keypoints by `flip_idx`. `hyp` maps the keys of
    `cfg/default.py` (the mosaic9, mixup, copy_paste and flip keys default
    to JAX's fallbacks). Mutates nothing; returns {"img", "boxes", "cls"}
    and the item's `masks` / `keypoints`."""
    rng = rng or random
    task_keys = [k for k in TASK_KEYS if k in item]
    use_mosaic = rng.random() < hyp.get("mosaic", 1.0)
    if use_mosaic and len(buffer) >= 3:
        use9 = (rng.random() < hyp.get("mosaic9", 0.0)) and len(buffer) >= 8
        n_extra = 8 if use9 else 3
        picks = [item] + [buffer[rng.randrange(len(buffer))] for _ in range(n_extra)]
        img, boxes, cls, extras = mosaic9(picks, imgsz) if use9 else mosaic4(picks, imgsz, rng)
        border = (-imgsz // 2, -imgsz // 2)
    else:
        img0, r, (dw, dh) = letterbox(item["img"], (imgsz, imgsz), scaleup=True)
        boxes = item["boxes"].copy()
        if len(boxes):
            boxes[:, [0, 2]] = boxes[:, [0, 2]] * r[0] + dw
            boxes[:, [1, 3]] = boxes[:, [1, 3]] * r[1] + dh
        img, cls, extras = img0, item["cls"], {}
        if "masks" in item:
            h0, w0 = item["img"].shape[:2]
            nh, nw = int(round(h0 * r[1])), int(round(w0 * r[0]))
            planes = np.zeros((len(item["masks"]), img.shape[0], img.shape[1]), np.float32)
            ty, tx = int(round(dh - 0.1)), int(round(dw - 0.1))
            for k, m in enumerate(item["masks"]):
                planes[k, ty:ty + nh, tx:tx + nw] = imgproc.resize_nearest(m, (nw, nh))
            extras["masks"] = planes
        if "keypoints" in item:
            kp = item["keypoints"].copy()
            kp[..., 0] = kp[..., 0] * r[0] + dw
            kp[..., 1] = kp[..., 1] * r[1] + dh
            extras["keypoints"] = kp
        border = (0, 0)
    cp = hyp.get("copy_paste", 0.0)
    if cp and "masks" in extras and len(extras["masks"]):
        img, boxes, cls, extras["masks"] = copy_paste(img, boxes, cls, extras["masks"], p=cp,
                                                      rng=rng)
    img, boxes, cls, extras = random_perspective(
        img, boxes, cls, degrees=hyp["degrees"], translate=hyp["translate"],
        scale=hyp["scale"], shear=hyp["shear"], perspective=hyp["perspective"],
        border=border, rng=rng, masks=extras.get("masks"), keypoints=extras.get("keypoints"))
    # drawn whatever the buffer holds, so later draws do not depend on it
    if rng.random() < hyp.get("mixup", 0.0) and buffer and not task_keys:
        other = buffer[rng.randrange(len(buffer))]
        o_img, o_boxes = _letterboxed(other, img.shape[:2])
        mixed = mixup({"img": img, "boxes": boxes, "cls": cls},
                      {"img": o_img, "boxes": o_boxes, "cls": other["cls"]}, rng)
        img, boxes, cls = mixed["img"], mixed["boxes"], mixed["cls"]
    if not task_keys:
        img, boxes, cls = ALBUMENTATIONS(img, boxes, cls, rng)
    img = augment_hsv(img, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"], rng)
    h, w = img.shape[:2]
    masks, kpts = extras.get("masks"), extras.get("keypoints")
    if rng.random() < hyp.get("flipud", 0.0):
        img = np.flipud(img).copy()
        if len(boxes):
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        if masks is not None and len(masks):
            masks = masks[:, ::-1].copy()
        if kpts is not None and len(kpts):
            kpts = kpts.copy()
            kpts[..., 1] = np.where(kpts[..., 2] > 0, h - kpts[..., 1], 0.0)
    if rng.random() < hyp.get("fliplr", 0.0):
        img = np.fliplr(img).copy()
        if len(boxes):
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if masks is not None and len(masks):
            masks = masks[:, :, ::-1].copy()
        if kpts is not None and len(kpts):
            kpts = kpts.copy()
            kpts[..., 0] = np.where(kpts[..., 2] > 0, w - kpts[..., 0], 0.0)
            if flip_idx is not None:
                kpts = kpts[:, list(flip_idx)]
    out = {"img": img, "boxes": boxes, "cls": cls}
    if masks is not None:
        out["masks"] = masks
    if kpts is not None:
        out["keypoints"] = kpts
    return out
