"""cv2's 8-bit image primitives in numpy, for the host augmentation pipeline.

The JAX package's host pipeline (`mgdt_yolo_tpu/data/augment.py`) calls cv2
for its warps, colour conversions and filters. The card's host has no cv2,
so each primitive here computes what cv2 5.0 computes on uint8 images, by
cv2's own arithmetic, found by experiment against cv2 5.0.0 on the CPU:

* `warp_affine` / `warp_perspective` (INTER_LINEAR, BORDER_CONSTANT; uint8,
  or float32, the masks, with the same blend unrounded, bit for bit): the
  matrix inverted in double as cv2 inverts it, then cast to float32; per
  output pixel the source coordinate in float32, `fma(M0, x, y*M1 + M2)`
  (perspective: that over `fma(M6, x, y*M7 + M8)`), its floor and
  fraction, and a float32 bilinear blend of the four taps,
  `fma(ax, p01 - p00, p00)` per row then `fma(ay, b - a, a)`, rounded to
  nearest even; a tap outside the image takes the border value. This is
  cv2's vector code; cv2 computes the last few pixels of each row (the
  width modulo its 16-pixel step) in scalar code whose coordinates round
  differently, so one grey level may differ there near a .5 tie. There is
  no fixed-point sub-pixel table in cv2 5.0's path.
* `rotation_matrix_2d`: `getRotationMatrix2D` in double, bit for bit.
* `bgr_to_hsv` (hue 0-180): cv2's 12-bit fixed point with its division
  tables, bit for bit over all 2^24 colours; `hsv_to_bgr`: cv2's float32
  vector code (with its fused multiply-adds) truncated to uint8, bit for
  bit over all 2^24 triples in rows whose width is a multiple of 32 (the
  pipeline's always are); cv2 converts the last (width mod 32) pixels of a
  row in scalar code, which can differ there by one level.
* `box_blur` (`cv2.blur`, BORDER_REFLECT_101), `median_blur` (replicated
  border), `rgb_to_gray` (15-bit weights 9798, 19235, 3735), `gray_to_bgr`
  and `clahe` (8x8 tiles; cv2's clip, redistribution, float32 LUT scale
  and float32 bilinear blend of the tile LUTs): bit for bit.
* `rgb_to_lab` / `lab_to_rgb`: cv2's integer paths (gamma, cube-root and
  inverse tables in fixed point). cv2 builds its tables with its own
  soft-float library, which these double-precision tables do not follow
  in every entry: `rgb_to_lab` differs from cv2 by one level in 3e-5 of
  the values over all colours, `lab_to_rgb` by at most two levels in 1.6%.

A fused multiply-add of float32 values is taken in float64 and rounded
once to float32: for the magnitudes here (pixel values, coordinates below
2^16) the float64 sum is exact, so the result is the fused one.

The hot loops, the warps' bilinear sampling, the HSV jitter's conversions
(`hsv_luts`) and the median filter, run in C++ (`native/src/
host_augment.cpp`, built by g++ at first use, the GIL released while it
runs), which follows the numpy arithmetic here step for step; `plain=True`
takes the numpy version, which the tests hold the C++ to bit for bit.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

F32 = np.float32


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load `native/src/host_augment.cpp`."""
    from ..utils.build import HOST_AUGMENT, load_library
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return load_library(HOST_AUGMENT, (
        ("mgdt_sample", None, (p, i32, i32, i32, p, p, i64, p, p)),
        ("mgdt_hsv_luts", None, (p, i64, p, p, p, p, p, p)),
        ("mgdt_median", None, (p, i32, i32, i32, i32, p)),
    ))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _u8(img: np.ndarray) -> np.ndarray:
    """`img` as the C++ takes it: uint8, C-contiguous."""
    if img.dtype != np.uint8:
        raise TypeError(f"a uint8 image is needed, not {img.dtype}")
    return np.ascontiguousarray(img)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (see the module docstring)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D(center, angle, scale)`: (2, 3) float64; the
    center is taken in float32, as cv2's `Point2f`."""
    cx, cy = float(F32(center[0])), float(F32(center[1]))
    angle = angle * (math.pi / 180)
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M) -> np.ndarray:
    """The inverse of a (2, 3) affine map, in double as `warpAffine` takes it."""
    m = [float(v) for v in np.asarray(M, np.float64)[:2].ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m).reshape(2, 3)


def invert_3x3(M) -> np.ndarray:
    """The inverse of a 3x3 matrix by cofactors in double, as `cv2.invert`
    takes a 3x3 (`warpPerspective`'s inversion); zeros if singular."""
    s = [[float(v) for v in row] for row in np.asarray(M, np.float64)]
    d = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
         - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
         + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    t = [(s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d, (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
         (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d, (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
         (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d, (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
         (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d, (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
         (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]
    return np.array(t).reshape(3, 3)


def _sample(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border,
            plain: bool = False) -> np.ndarray:
    """Bilinear samples of `img` (H, W, C) uint8 at float32 source
    coordinates (h, w), cv2's float32 blend; taps outside take `border`.
    A float32 image (the masks) takes the same blend without the rounding,
    in numpy, as cv2 warps a float32 image."""
    floating = img.dtype == F32
    if not plain and not floating:
        img = _u8(img)
        sx, sy = np.ascontiguousarray(sx, F32), np.ascontiguousarray(sy, F32)
        H, W, C = img.shape
        out = np.empty((*sx.shape, C), np.uint8)
        fill = np.ascontiguousarray(np.asarray(border, np.uint8)[:C])
        _lib().mgdt_sample(_ptr(img), H, W, C, _ptr(sx), _ptr(sy), sx.size, _ptr(fill),
                           _ptr(out))
        return out
    H, W, C = img.shape
    h, w = sx.shape
    # two border pixels on every side: a coordinate clamped to [-2, W] keeps
    # both its taps on the border whenever either lies outside
    pad = np.empty((H + 4, W + 4, C), img.dtype)
    pad[...] = np.asarray(border, img.dtype)[:C]
    pad[2:-2, 2:-2] = img
    flat = pad.reshape(-1, C)
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx).reshape(-1, 1), (sy - fy).reshape(-1, 1)
    ix = np.clip(fx, -2, W).astype(np.int64) + 2
    iy = np.clip(fy, -2, H).astype(np.int64) + 2
    i00 = (iy * (W + 4) + ix).reshape(-1)
    p00, p01 = flat[i00].astype(F32), flat[i00 + 1].astype(F32)
    p10, p11 = flat[i00 + W + 4].astype(F32), flat[i00 + W + 5].astype(F32)
    a = _fma(ax, p01 - p00, p00)
    b = _fma(ax, p11 - p10, p10)
    v = _fma(ay, b - a, a)
    if floating:
        return v.reshape(h, w, C)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8).reshape(h, w, C)


def _as3(img: np.ndarray):
    return (img, False) if img.ndim == 3 else (img[..., None], True)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)` for an (H, W[,
    C]) image of any type; `size` is (width, height). Output index i reads
    min(floor(i * (1 / (dst / src))), src - 1) on each axis, in double, as
    cv2 does."""
    dw, dh = size
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
    return np.ascontiguousarray(img[ys][:, xs])


def _grid(dsize, region):
    """The output columns and rows to compute: all of `dsize` (w, h), or the
    `region` (x0, y0, x1, y1) of it."""
    w, h = dsize
    x0, y0, x1, y1 = region or (0, 0, w, h)
    return (np.arange(x0, x1, dtype=F32)[None, :], np.arange(y0, y1, dtype=F32)[:, None],
            (x0, y0, x1, y1))


def _place(out, dsize, box, border_value, squeeze):
    """`out`, computed over `box` (x0, y0, x1, y1), in an output of `dsize`
    filled with `border_value` elsewhere."""
    w, h = dsize
    x0, y0, x1, y1 = box
    if (x0, y0, x1, y1) != (0, 0, w, h):
        full = np.empty((h, w, out.shape[2]), out.dtype)
        full[...] = np.asarray(border_value, out.dtype)[:out.shape[2]]
        full[y0:y1, x0:x1] = out
        out = full
    return out[..., 0] if squeeze else out


def warp_affine(img: np.ndarray, M, dsize: Tuple[int, int], border_value=(0, 0, 0),
                plain: bool = False, region=None) -> np.ndarray:
    """`cv2.warpAffine(img, M, dsize, borderValue=border_value)` (INTER_LINEAR,
    BORDER_CONSTANT) for a uint8 or float32 (H, W[, C]) image; `M` (2, 3)
    maps source to output, `dsize` is (width, height). With `region` (x0,
    y0, x1, y1) only those output pixels are computed (each as the whole
    warp computes it), the rest take the border value."""
    x3, squeeze = _as3(img)
    m = invert_affine(M).astype(F32).ravel()
    x, y, box = _grid(dsize, region)
    mx, my = y * m[1] + m[2], y * m[4] + m[5]
    out = _sample(x3, _fma(m[0], x, mx), _fma(m[3], x, my), border_value, plain)
    return _place(out, dsize, box, border_value, squeeze)


def warp_perspective(img: np.ndarray, M, dsize: Tuple[int, int],
                     border_value=(0, 0, 0), plain: bool = False, region=None) -> np.ndarray:
    """`cv2.warpPerspective(img, M, dsize, borderValue=border_value)`
    (INTER_LINEAR, BORDER_CONSTANT) for a uint8 or float32 image; `M` (3, 3)
    maps source to output. An output pixel whose homogeneous weight is 0 takes
    the border value. `region` as for `warp_affine`."""
    x3, squeeze = _as3(img)
    m = invert_3x3(M).astype(F32).ravel()
    x, y, box = _grid(dsize, region)
    mx, my, mw = y * m[1] + m[2], y * m[4] + m[5], y * m[7] + m[8]
    ww = _fma(m[6], x, mw)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = _fma(m[0], x, mx) / ww
        sy = _fma(m[3], x, my) / ww
    bad = ~(np.isfinite(sx) & np.isfinite(sy))
    sx[bad], sy[bad] = -3.0, -3.0
    out = _sample(x3, sx.astype(F32), sy.astype(F32), border_value, plain)
    return _place(out, dsize, box, border_value, squeeze)


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << 12) / i), 0).astype(np.int32)
        hdiv = np.where(i > 0, np.rint((180 << 12) / (6 * i)), 0).astype(np.int32)
    return sdiv, hdiv


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2HSV)` for uint8: H in 0-179."""
    sdiv, hdiv = _hsv_tables()
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_HSV2BGR)` for uint8 (H in 0-179)."""
    one = F32(1.0)
    h = img[..., 0].astype(F32) * F32(6.0 / 180)
    s = img[..., 1].astype(F32) * F32(1.0 / 255)
    v = img[..., 2].astype(F32) * F32(1.0 / 255)
    pre = np.trunc(h)
    h = h - pre
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one), v * _fma(-s, one - h, one)], -1)
    sector = _fma(-np.trunc(pre * F32(1.0 / 6)), F32(6.0), pre).astype(np.int64)
    out = np.take_along_axis(tab, _SECTORS[np.clip(sector, 0, 5)], -1)
    out = np.where((s == 0)[..., None], v[..., None], out)
    return np.clip(np.trunc(out * F32(255.0)), 0, 255).astype(np.uint8)


def hsv_luts(img: np.ndarray, lut_h, lut_s, lut_v, plain: bool = False) -> np.ndarray:
    """A BGR uint8 image to HSV (`bgr_to_hsv`), each channel through its
    256-entry uint8 LUT, and back (`hsv_to_bgr`): the HSV jitter's
    conversions."""
    if plain:
        hsv = bgr_to_hsv(img)
        return hsv_to_bgr(np.stack([lut(hsv[..., 0], lut_h), lut(hsv[..., 1], lut_s),
                                    lut(hsv[..., 2], lut_v)], -1))
    img = _u8(img)
    if img.shape[-1] != 3:
        raise ValueError(f"a BGR image is needed, not one of shape {img.shape}")
    luts = [np.ascontiguousarray(t, np.uint8) for t in (lut_h, lut_s, lut_v)]
    if any(t.shape != (256,) for t in luts):
        raise ValueError("each LUT has 256 entries")
    sdiv, hdiv = _hsv_tables()
    out = np.empty_like(img)
    _lib().mgdt_hsv_luts(_ptr(img), img.size // 3, *(_ptr(t) for t in luts), _ptr(sdiv),
                         _ptr(hdiv), _ptr(out))
    return out


def lut(img: np.ndarray, table) -> np.ndarray:
    """`cv2.LUT(img, table)` for uint8 images and a 256-entry table."""
    return np.asarray(table)[img]


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`: channel 0 is taken as R."""
    x = img.astype(np.int32)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


def gray_to_bgr(gray: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)`."""
    return np.repeat(gray[..., None], 3, -1)


# sRGB -> XYZ (D65) and back, and the D65 white point, as cv2 holds them
_RGB2XYZ = (0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
            0.019334, 0.119193, 0.950227)
_XYZ2RGB = (3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
            0.055648, -0.204043, 1.057311)
_D65 = (0.950456, 1.0, 1.088754)
_LAB_SHIFT, _LAB_SHIFT2, _BASE = 12, 15, 1 << 14
_AB_LO, _AB_HI = -2 * _BASE, 3 * _BASE    # the range of abToXZ's argument


def _round(x) -> np.ndarray:
    return np.rint(np.asarray(x, np.float64)).astype(np.int64)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


@lru_cache(maxsize=None)
def _lab_tables():
    i = np.arange(256) / 255.0
    gamma = _round(255 * 8 * np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4))
    x = np.arange(3072) / (255.0 * 8)
    cbrt = _round((1 << _LAB_SHIFT2) * np.where(x < 216 / 24389, x * (841 / 108) + 16 / 116,
                                                np.cbrt(x)))
    fwd = np.array([[_round((1 << _LAB_SHIFT) * _RGB2XYZ[r * 3 + c] / _D65[r]) for c in range(3)]
                    for r in range(3)])
    lum = np.arange(256) * 100 / 255.0
    y = np.where(lum <= 8, lum / 903.3, ((lum + 16) / 116) ** 3)
    fy = np.where(lum <= 8, lum / 903.3 * 7.787 + 16 / 116, (lum + 16) / 116)
    v = np.arange(_AB_LO, _AB_HI) / _BASE
    xz = np.where(v <= 6 / 29, (v - 16 / 116) * (108 / 841), v ** 3)
    g = np.arange(4096) / 4096
    inv_gamma = _round(255 * np.where(g <= 0.0031308, g * 12.92, 1.055 * g ** (1 / 2.4) - 0.055))
    inv = np.array([[_round((1 << _LAB_SHIFT) * _XYZ2RGB[r * 3 + c] * _D65[c]) for c in range(3)]
                    for r in range(3)])
    return (gamma, cbrt, fwd, _round(y * _BASE), _round(fy * _BASE), _round(xz * _BASE),
            inv_gamma, inv)


def rgb_to_lab(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2LAB)` for uint8 (channel 0 taken
    as R): cv2's integer path (see the module docstring for its limit)."""
    gamma, cbrt, fwd = _lab_tables()[:3]
    rgb = [gamma[img[..., k]] for k in range(3)]
    fx, fy, fz = (cbrt[_descale(rgb[0] * fwd[r, 0] + rgb[1] * fwd[r, 1] + rgb[2] * fwd[r, 2],
                                _LAB_SHIFT)] for r in range(3))
    lscale, lshift = (116 * 255 + 50) // 100, -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    half = 128 * (1 << _LAB_SHIFT2)
    lab = np.stack([_descale(lscale * fy + lshift, _LAB_SHIFT2),
                    _descale(500 * (fx - fy) + half, _LAB_SHIFT2),
                    _descale(200 * (fy - fz) + half, _LAB_SHIFT2)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def lab_to_rgb(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_LAB2RGB)` for uint8: cv2's integer
    path (see the module docstring for its limit)."""
    _, _, _, ytab, ftab, xztab, inv_gamma, inv = _lab_tables()
    lum, a, b = (img[..., k].astype(np.int64) for k in range(3))
    y, fy = ytab[lum], ftab[lum]
    # a / 500 and b / 200 in 14-bit fixed point, by cv2's integer recipes
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    x, z = xztab[fy + adiv - _AB_LO], xztab[fy - bdiv - _AB_LO]
    shift = _LAB_SHIFT + 2
    out = [inv_gamma[np.clip(_descale(inv[r, 0] * x + inv[r, 1] * y + inv[r, 2] * z, shift),
                             0, 4095)] for r in range(3)]
    return np.stack(out, -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.blur(img, (k, k))` for uint8, k odd: the rounded mean of each
    k x k window, the border mirrored without repeating the edge
    (BORDER_REFLECT_101). k * k is odd, so no mean falls on a half."""
    x3, squeeze = _as3(img)
    p = k // 2
    pad = np.pad(x3, ((p, p), (p, p), (0, 0)), mode="reflect").astype(np.int32)
    H, W = x3.shape[:2]
    rows = sum(pad[:, j:j + W] for j in range(k))
    s = sum(rows[i:i + H] for i in range(k))
    out = ((2 * s + k * k) // (2 * k * k)).astype(np.uint8)
    return out[..., 0] if squeeze else out


def median_blur(img: np.ndarray, k: int, plain: bool = False) -> np.ndarray:
    """`cv2.medianBlur(img, k)` for uint8, k 3, 5 or 7: the median of each
    k x k window, the edge pixels replicated."""
    if k not in (3, 5, 7):
        raise ValueError(f"median_blur takes k 3, 5 or 7, not {k}")
    x3, squeeze = _as3(img)
    if not plain:
        x3 = _u8(x3)
        out = np.empty_like(x3)
        _lib().mgdt_median(_ptr(x3), *x3.shape, k, _ptr(out))
        return out[..., 0] if squeeze else out
    p = k // 2
    pad = np.pad(x3, ((p, p), (p, p), (0, 0)), mode="edge")
    H, W = x3.shape[:2]
    win = np.stack([pad[i:i + H, j:j + W] for i in range(k) for j in range(k)], -1)
    out = np.partition(win, k * k // 2, axis=-1)[..., k * k // 2]
    return out[..., 0] if squeeze else out


def clahe(gray: np.ndarray, clip_limit: float, tiles: Sequence[int] = (8, 8)) -> np.ndarray:
    """`cv2.createCLAHE(clip_limit, tiles).apply(gray)` for a uint8 (H, W)
    image: a clipped histogram equalisation per tile (the image extended by
    BORDER_REFLECT_101 to a whole number of tiles, as cv2 extends it), the
    clipped counts spread evenly and their remainder by cv2's step, each
    tile's LUT scaled in float32, and every pixel blended in float32 from
    its four nearest tiles' LUTs."""
    tx, ty = tiles
    H, W = gray.shape
    ext = gray
    if W % tx or H % ty:  # cv2 then extends both axes, a whole tile where one divides
        ext = np.pad(gray, ((0, ty - H % ty), (0, tx - W % tx)), mode="reflect")
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    scale = F32(255.0) / F32(area)
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    luts = np.empty((ty, tx, 256), np.uint8)
    for j in range(ty):
        for i in range(tx):
            hist = np.bincount(ext[j * th:(j + 1) * th, i * tw:(i + 1) * tw].ravel(),
                               minlength=256).astype(np.int64)
            if limit:
                clipped = int(np.maximum(hist - limit, 0).sum())
                hist = np.minimum(hist, limit) + clipped // 256
                resid = clipped % 256
                if resid:
                    step = max(256 // resid, 1)
                    hist[np.arange(0, 256, step)[:resid]] += 1
            luts[j, i] = np.clip(np.rint(np.cumsum(hist).astype(F32) * scale), 0, 255)
    txf = np.arange(W, dtype=F32) * (F32(1.0) / F32(tw)) - F32(0.5)
    tyf = np.arange(H, dtype=F32) * (F32(1.0) / F32(th)) - F32(0.5)
    tx1, ty1 = np.floor(txf).astype(np.int64), np.floor(tyf).astype(np.int64)
    xa, ya = txf - tx1.astype(F32), (tyf - ty1.astype(F32))[:, None]
    xa1, ya1 = F32(1.0) - xa, F32(1.0) - ya
    tx2, ty2 = np.minimum(tx1 + 1, tx - 1), np.minimum(ty1 + 1, ty - 1)
    tx1, ty1 = np.maximum(tx1, 0), np.maximum(ty1, 0)
    g = gray.astype(np.int64)

    def tap(ty_, tx_):
        return luts[ty_[:, None], tx_[None, :], g].astype(F32)
    res = (tap(ty1, tx1) * xa1 + tap(ty1, tx2) * xa) * ya1 + \
        (tap(ty2, tx1) * xa1 + tap(ty2, tx2) * xa) * ya
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
