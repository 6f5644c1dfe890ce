"""Drawing and image writing without cv2: the cv2 calls the JAX package's
plots make, with cv2's arithmetic, in `native/src/host_draw.cpp` (g++ at
first use, `utils/build.py`), bound with ctypes.

* `line`, `rectangle`, `circle`, `fill_convex_poly`, `polylines`: cv2's
  functions of the same names on a uint8 (h, w, 3) or (h, w) C-contiguous
  image, in place; `line_type` `LINE_8` or `LINE_AA`, `shift` fractional
  bits, thickness -1 fills. `fill_poly` is cv2's `fillPoly` (any polygon,
  LINE_8 edges).
* `put_text` and `get_text_size`: cv2's with `FONT_HERSHEY_SIMPLEX`. cv2 5
  draws that face as anti-aliased outline glyphs at a regular weight
  (thickness 1) or a bold one (above), whatever the line type; the glyphs
  are committed bitmaps probed from cv2 (`native/glyphs_simplex.npz`,
  `tests/torch_draw_probe.py`) at the scales the plots use: 0.5 and
  `lw / 3` for `lw` 2-10. At any other scale the nearest probed one of the
  same weight is resampled (nearest neighbour), which cv2 does not do.
* `imwrite(path, img)`: a BGR (or grey) image to `.jpg`/`.jpeg` (baseline
  JPEG, quality 95, 4:2:0 chroma: cv2's defaults) or `.png`; any other
  suffix raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Tuple

import numpy as np

LINE_8, LINE_AA = 8, 16
ATLAS = Path(__file__).resolve().parents[1] / "native" / "glyphs_simplex.npz"
JPEG_QUALITY = 95
# how far a decoder's reading of `encode_jpeg`'s file may stray from
# `jpeg_reference`, in mean grey levels: decoders round their inverse DCT and
# chroma upsampling their own ways (cv2 and the card's nvJPEG read drawn
# scenes within 0.45; single pixels at sharp colour edges differ by up to 29)
JPEG_READ_MEAN = 1.0
# and its PSNR against the array drawn at most this many dB below the same
# decoder's reading of libjpeg's own quality-95 4:2:0 file of the array
# (cv2.imwrite's default), as the CPU tests hold cv2's reading
JPEG_READ_PSNR_DB = 0.5
PNG_LEVEL = 1   # cv2.imwrite's default compression


@functools.cache
def _lib() -> ctypes.CDLL:
    from .build import HOST_DRAW, load_library
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    img = (p, i32, i32, i32)
    return load_library(HOST_DRAW, (
        ("mgdt_line", None, (*img, i64, i64, i64, i64, p, i32, i32, i32)),
        ("mgdt_rectangle", None, (*img, i64, i64, i64, i64, p, i32, i32, i32)),
        ("mgdt_circle", None, (*img, i64, i64, i64, p, i32, i32, i32)),
        ("mgdt_fill_convex_poly", None, (*img, p, i32, p, i32, i32)),
        ("mgdt_fill_poly", None, (*img, p, p, i32, p, i32)),
        ("mgdt_polylines", None, (*img, p, i32, i32, p, i32, i32, i32)),
        ("mgdt_put_text", None, (*img, p, i32, i32, i32, p, p, p)),
        ("mgdt_encode_jpeg", p, (p, i32, i32, i32, i32, ctypes.POINTER(i64))),
        ("mgdt_encode_png", p, (p, i32, i32, i32, i32, ctypes.POINTER(i64))),
        ("mgdt_free", None, (p,)),
    ))


def _img(img: np.ndarray):
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or not img.flags.c_contiguous or \
            (img.ndim == 3 and img.shape[2] not in (1, 3)) or not img.flags.writeable:
        raise ValueError("the image must be a writeable C-contiguous uint8 (h, w, 3) or (h, w) "
                         f"array, got {img.dtype} {img.shape}")
    c = 1 if img.ndim == 2 else img.shape[2]
    return img.ctypes.data, img.shape[0], img.shape[1], c


def _color(color, c: int) -> np.ndarray:
    """cv2's Scalar to the image's channels: rounded, saturated."""
    v = np.zeros(4)
    vals = [color] if np.isscalar(color) else list(color)
    v[:len(vals)] = vals
    return np.ascontiguousarray(np.clip(np.rint(v[:c]), 0, 255).astype(np.uint8))


def line(img, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8, shift: int = 0):
    i = _img(img)
    col = _color(color, i[3])
    _lib().mgdt_line(*i, int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1]), col.ctypes.data,
                     int(thickness), int(line_type), int(shift))
    return img


def rectangle(img, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8,
              shift: int = 0):
    i = _img(img)
    col = _color(color, i[3])
    _lib().mgdt_rectangle(*i, int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1]),
                          col.ctypes.data, int(thickness), int(line_type), int(shift))
    return img


def circle(img, center, radius: int, color, thickness: int = 1, line_type: int = LINE_8,
           shift: int = 0):
    i = _img(img)
    col = _color(color, i[3])
    _lib().mgdt_circle(*i, int(center[0]), int(center[1]), int(radius), col.ctypes.data,
                       int(thickness), int(line_type), int(shift))
    return img


def _points(pts) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(pts).reshape(-1, 2).astype(np.int64))


def fill_convex_poly(img, pts, color, line_type: int = LINE_8, shift: int = 0):
    i = _img(img)
    p = _points(pts)
    col = _color(color, i[3])
    _lib().mgdt_fill_convex_poly(*i, p.ctypes.data, len(p), col.ctypes.data, int(line_type),
                                 int(shift))
    return img


def fill_poly(img, polys, color, line_type: int = LINE_8, shift: int = 0):
    """cv2.fillPoly: every polygon of `polys` (each (n, 2) integer (x, y)
    points), convex or not, crossing itself or not, filled by the even-odd
    rule of cv2's edge-collection scanline, with its edges drawn as 8-connected
    lines (LINE_8, the only line type taken here)."""
    if line_type != LINE_8:
        raise ValueError(f"fill_poly draws LINE_8 edges only, got line_type {line_type}")
    i = _img(img)
    pts = [_points(q) for q in polys]
    flat = np.ascontiguousarray(np.concatenate(pts) if pts else np.zeros((0, 2), np.int64))
    counts = np.ascontiguousarray([len(q) for q in pts], dtype=np.int32)
    col = _color(color, i[3])
    _lib().mgdt_fill_poly(*i, flat.ctypes.data, counts.ctypes.data, len(pts), col.ctypes.data,
                          int(shift))
    return img


def polylines(img, pts, closed: bool, color, thickness: int = 1, line_type: int = LINE_8,
              shift: int = 0):
    i = _img(img)
    p = _points(pts)
    col = _color(color, i[3])
    _lib().mgdt_polylines(*i, p.ctypes.data, len(p), int(bool(closed)), col.ctypes.data,
                          int(thickness), int(line_type), int(shift))
    return img


# ---- text ----------------------------------------------------------------
@functools.cache
def _atlas() -> dict:
    """{(scale, bold): (alpha, glyphs, height, width extra)} of the probed
    faces."""
    out = {}
    with np.load(ATLAS) as f:
        for key in {k.split("/")[0] for k in f.files}:
            out[(float(f[f"{key}/scale"]), bool(f[f"{key}/bold"]))] = (
                np.ascontiguousarray(f[f"{key}/alpha"]),
                np.ascontiguousarray(f[f"{key}/glyphs"]), *map(int, f[f"{key}/meta"]))
    return out


@functools.cache
def face(scale: float, thickness: int):
    """The glyphs of FONT_HERSHEY_SIMPLEX at `scale` and `thickness`'s
    weight: (alpha, glyphs, height, width extra); a probed face, or the
    nearest probed one of the weight resampled."""
    bold = int(thickness) > 1
    faces = _atlas()
    for (s, b), f in faces.items():
        if b == bold and abs(s - scale) < 1e-9:
            return f
    same = [k for k in faces if k[1] == bold] or list(faces)
    s0, b0 = min(same, key=lambda k: abs(np.log(k[0] / scale)))
    alpha, glyphs, height, extra = faces[(s0, b0)]
    f = scale / s0
    bitmaps, rows, off = [], [], 0
    for g in glyphs:
        o, w, h, dx, dy, adv, desc = (int(v) for v in g)
        nw, nh = max(int(round(w * f)), 1 if w else 0), max(int(round(h * f)), 1 if h else 0)
        if w and h:
            src = alpha[o:o + w * h].reshape(h, w)
            ys = np.minimum((np.arange(nh) / f).astype(int), h - 1)
            xs = np.minimum((np.arange(nw) / f).astype(int), w - 1)
            bitmaps.append(src[ys][:, xs].ravel())
        rows.append([off, nw, nh, int(round(dx * f)), int(round(dy * f)), int(round(adv * f)),
                     int(round(desc * f))])
        off += nw * nh
    return (np.ascontiguousarray(np.concatenate(bitmaps).astype(np.uint8)),
            np.ascontiguousarray(np.asarray(rows, np.int32)), int(round(height * f)), extra)


def _codes(text: str) -> np.ndarray:
    return np.asarray([ord(ch) if 32 <= ord(ch) < 127 else ord("?") for ch in str(text)],
                      np.int32)


def get_text_size(text: str, scale: float, thickness: int = 1) -> Tuple[Tuple[int, int], int]:
    """((width, height), baseline) of `text`, as cv2.getTextSize gives them
    for FONT_HERSHEY_SIMPLEX."""
    codes = _codes(text)
    if not len(codes):
        return (0, 0), 0
    _, glyphs, height, extra = face(float(scale), int(thickness))
    g = glyphs[codes - 32]
    return (int(g[:, 5].sum()) + extra, height), int(g[:, 6].max())


def put_text(img, text: str, org, scale: float, color, thickness: int = 1,
             line_type: int = LINE_8):
    """cv2.putText with FONT_HERSHEY_SIMPLEX, `org` the baseline's left end
    (the line type does not change cv2 5's glyphs)."""
    i = _img(img)
    codes = _codes(text)
    if not len(codes):
        return img
    alpha, glyphs, _, _ = face(float(scale), int(thickness))
    col = _color(color, i[3])
    _lib().mgdt_put_text(*i, codes.ctypes.data, len(codes), int(org[0]), int(org[1]),
                         alpha.ctypes.data, glyphs.ctypes.data, col.ctypes.data)
    return img


# ---- image writers -------------------------------------------------------
def _encode(fn, img: np.ndarray, arg: int) -> bytes:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or not img.size or \
            (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"an image to write must be non-empty uint8 (h, w, 3) or (h, w), got "
                         f"{img.dtype} {img.shape}")
    c = 1 if img.ndim == 2 else img.shape[2]
    n = ctypes.c_int64(0)
    lib = _lib()
    ptr = getattr(lib, fn)(img.ctypes.data, img.shape[0], img.shape[1], c, arg, ctypes.byref(n))
    if not ptr or n.value < 0:
        raise RuntimeError(f"{fn} failed for an image of shape {img.shape}")
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.mgdt_free(ptr)


def encode_jpeg(img: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """A baseline JPEG of a BGR (or grey) image: 4:2:0 chroma, libjpeg's
    quality scaling and standard Huffman tables."""
    return _encode("mgdt_encode_jpeg", img, int(quality))


def encode_png(img: np.ndarray, level: int = PNG_LEVEL) -> bytes:
    """An 8-bit PNG of a BGR (or grey) image, zlib at `level`."""
    return _encode("mgdt_encode_png", img, int(level))


def imwrite(path, img: np.ndarray) -> bool:
    """Write a BGR (or grey) uint8 image to `path`, JPEG or PNG by its
    suffix (cv2.imwrite's defaults); any other suffix raises."""
    suffix = Path(str(path)).suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        data = encode_jpeg(img)
    elif suffix == ".png":
        data = encode_png(img)
    else:
        raise ValueError(f"{path}: the port writes .jpg, .jpeg and .png images only")
    Path(str(path)).write_bytes(data)
    return True


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    """The PSNR of `a` against `b` in dB (8-bit peak; inf where equal)."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * math.log10(255 ** 2 / mse) if mse else math.inf


def jpeg_reading(back: np.ndarray, img: np.ndarray, libjpeg_back: np.ndarray,
                 reference: np.ndarray = None) -> dict:
    """How a decoder's reading `back` of `encode_jpeg(img)` holds: its mean
    and largest grey-level difference from `jpeg_reference(img)` (or
    `reference`, that array computed before), its PSNR against `img` and
    that of the same decoder's reading `libjpeg_back` of libjpeg's own
    quality-95 4:2:0 file of `img`, the gap between the two, and `holds`:
    the mean within `JPEG_READ_MEAN` and the gap within `JPEG_READ_PSNR_DB`."""
    ref = jpeg_reference(img) if reference is None else reference
    if back.shape != img.shape or libjpeg_back.shape != img.shape:
        raise ValueError(f"read back {back.shape} and {libjpeg_back.shape}, drawn {img.shape}")
    d = np.abs(back.astype(np.int16) - ref)
    psnr, lib = psnr_db(back, img), psnr_db(libjpeg_back, img)
    gap = 0.0 if psnr == lib else lib - psnr
    return {"mean_diff": float(d.mean()), "max_diff": int(d.max()), "psnr_db": psnr,
            "libjpeg_psnr_db": lib, "psnr_gap_db": gap,
            "holds": bool(d.mean() <= JPEG_READ_MEAN and gap <= JPEG_READ_PSNR_DB)}


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2)
    return m


def jpeg_reference(img: np.ndarray, quality: int = JPEG_QUALITY) -> np.ndarray:
    """What a decoder gives back of `encode_jpeg(img)`, in numpy: the
    encoder's colour conversion, 2x2 chroma averages, DCT and quantisation,
    then dequantisation, the inverse DCT, libjpeg's triangle ("fancy")
    chroma upsampling and its YCbCr to RGB conversion. A decoder reads the
    file back as `jpeg_reading` holds it to."""
    img = np.ascontiguousarray(img)
    grey = img.ndim == 2
    h, w = img.shape[:2]
    mcu = 8 if grey else 16
    ph, pw = -(-h // mcu) * mcu, -(-w // mcu) * mcu
    x = np.pad(img.astype(np.int64), [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2),
               mode="edge")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    luma = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16,
                     24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109,
                     103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120,
                     101, 72, 92, 95, 98, 112, 100, 103, 99])
    chroma = np.full(64, 99)
    chroma[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24,
                                                              26, 56, 47, 66]
    dct = _dct_matrix()

    def q(table):
        return np.clip((table * scale + 50) // 100, 1, 255).reshape(8, 8)

    def roundtrip(plane, table):
        H, W = plane.shape
        b = plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8) - 128.0
        qt = q(table)
        v = (dct @ b @ dct.T) / qt
        r = dct.T @ (np.sign(v) * np.floor(np.abs(v) + 0.5) * qt) @ dct + 128
        r = np.clip(np.rint(r), 0, 255).reshape(H // 8, W // 8, 8, 8)
        return r.transpose(0, 2, 1, 3).reshape(H, W)

    if grey:
        return roundtrip(x, luma)[:h, :w].astype(np.uint8)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]

    def fix(v):
        return int(v * 65536 + 0.5)
    off = (128 << 16) + (1 << 15) - 1
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + (1 << 15)) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off) >> 16
    bias = np.where(np.arange(pw // 2) % 2, 2, 1)

    def down(p):
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2

    def up(p):
        """libjpeg's h2v2 triangle filter: 3/4 of the nearer sample, 1/4 of
        the farther, in each direction, edges replicated."""
        p = p.astype(np.float64)
        pp = np.pad(p, 1, mode="edge")
        out = np.empty((2 * p.shape[0], 2 * p.shape[1]))
        for dy in (0, 1):
            v = 0.75 * pp[1:-1] + 0.25 * (pp[:-2] if dy == 0 else pp[2:])
            for dx in (0, 1):
                out[dy::2, dx::2] = 0.75 * v[:, 1:-1] + 0.25 * (v[:, :-2] if dx == 0 else v[:, 2:])
        return out

    Y = roundtrip(y, luma).astype(np.float64)
    Cb = up(roundtrip(down(cb), chroma)) - 128
    Cr = up(roundtrip(down(cr), chroma)) - 128
    out = np.stack([Y + 1.772 * Cb, Y - 0.34414 * Cb - 0.71414 * Cr, Y + 1.402 * Cr], -1)
    return np.clip(np.rint(out), 0, 255)[:h, :w].astype(np.uint8)
