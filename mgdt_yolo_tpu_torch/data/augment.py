"""The letterbox: an aspect-preserving resize and pad, without cv2.

A copy of the JAX package's `letterbox` (`mgdt_yolo_tpu/data/augment.py`),
which resizes with `cv2.resize(..., INTER_LINEAR)`. The card's host has no
cv2, so `resize_linear` computes cv2's 8-bit bilinear resize in numpy, by
cv2's own fixed-point recipe:

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
from typing import Dict, Tuple

import numpy as np

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
    """An item (`img` BGR uint8, `boxes` xyxy pixels, `cls`) resized so its
    long side is `imgsz`, boxes scaled with it, as the JAX
    `resize_long_side(augment=True)` does before augmentation (the JAX
    loader's only call): r = imgsz / max(h, w), the new sides
    min(ceil(side * r), imgsz), cv2's INTER_LINEAR (`resize_linear`)."""
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
    return out
