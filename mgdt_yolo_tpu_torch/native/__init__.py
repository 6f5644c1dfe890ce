"""The image decoder of the port's data pipeline, bound with ctypes.

A counterpart of the JAX package's `mgdt_yolo_tpu/native`: `src/host_loader.cpp`
decodes JPEG with nvJPEG on the card and PNG with zlib on the host, and
keeps the JAX loader's long-side bilinear resize, its paste into the
114-filled RGB canvas, its status codes and its thread pool. It is built
at first use into `_build/` (`utils/build.py`); a build that fails raises
with the compiler's message, and nothing falls back to another decoder.

* `load_batch(paths, imgsz)`: the JAX `load_batch`: canvases, pasted sizes
  and a status per image (`OK`, or a code for the caller to redo through
  the Python path: `ERR_EXIF` for a JPEG with an EXIF orientation, as JAX
  declines it).
* `decode(path)` / `decode_batch(paths)`: the full-size BGR image
  `cv2.imread` gives, EXIF orientation applied.

The host augmentation's hot loops, `src/host_augment.cpp`, are built the
same way and bound by `data/imgproc.py`.

Formats: JPEG (where the machine has a CUDA device) and PNG. Any other
suffix of `IMG_FORMATS` (`bmp`, `tif`, `tiff`, `webp`) raises
`UnsupportedFormat`, naming it; `decode` raises `DecodeError` for a file
it cannot read.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

# status codes (keep in sync with host_loader.cpp)
OK = 0
ERR_OPEN = -1
ERR_EXIF = -2
ERR_DECODE = -3
ERR_FORMAT = -4
ERR_COLORSPACE = -5
ERR_NO_JPEG = -6
STATUS = {OK: "ok", ERR_OPEN: "cannot open", ERR_EXIF: "EXIF-rotated JPEG",
          ERR_DECODE: "cannot decode", ERR_FORMAT: "neither JPEG nor PNG",
          ERR_COLORSPACE: "CMYK JPEG", ERR_NO_JPEG: "a JPEG, and JPEG decoding (nvJPEG) "
                                                    "needs a CUDA device"}
DECODED_SUFFIXES = ("jpg", "jpeg", "png")


class DecodeError(RuntimeError):
    """A file the decoder could not read; `status` holds its code."""

    def __init__(self, path, status: int):
        super().__init__(f"{path}: {STATUS.get(status, status)}")
        self.path, self.status = str(path), status


class UnsupportedFormat(NotImplementedError):
    """An image format the port does not decode (ROADMAP queue 1)."""


def check_format(path) -> None:
    """Raise `UnsupportedFormat`, naming it, for a suffix the decoder does
    not take."""
    suffix = Path(str(path)).suffix[1:].lower()
    if suffix not in DECODED_SUFFIXES:
        raise UnsupportedFormat(f"{path}: the port decodes {', '.join(DECODED_SUFFIXES)} only; "
                                f"{suffix or 'a file without a suffix'} is not decoded "
                                "(ROADMAP queue 1)")


@functools.cache
def get_lib() -> ctypes.CDLL:
    """Build (first use) and load the decoder."""
    from ..utils.build import HOST_LOADER, load_library
    ptr, i32, u8p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)
    paths = ctypes.POINTER(ctypes.c_char_p)
    return load_library(HOST_LOADER, (
        ("mgdt_has_jpeg", i32, ()),
        ("mgdt_load_batch", None, (paths, i32, i32, ctypes.c_uint8, u8p,
                                   ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                                   i32)),
        ("mgdt_decode", i32, (ctypes.c_char_p, ctypes.POINTER(ptr),
                              ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))),
        ("mgdt_decode_batch", None, (paths, i32, ctypes.POINTER(ptr),
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int), i32)),
        ("mgdt_free", None, (ptr,)),
    ))


def has_jpeg() -> bool:
    """Whether this machine's build decodes JPEG (nvJPEG, a CUDA device)."""
    return bool(get_lib().mgdt_has_jpeg())


def _paths(paths: Sequence) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def load_batch(paths: Sequence, imgsz: int, fill: int = 114, nthreads: int = 8
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threaded ingest of a batch of image files, the JAX `load_batch`.

    Returns `(imgs, hw, status)`: imgs (n, imgsz, imgsz, 3) uint8 RGB
    canvases (fill-padded, image pasted top-left after the long-side
    resize), hw (n, 2) float32 pasted (h, w), status (n,) int32, 0 where
    the image is in its canvas, else a negative `ERR_*` for the caller to
    redo through the Python path."""
    lib = get_lib()
    n = len(paths)
    imgs = np.empty((n, imgsz, imgsz, 3), np.uint8)
    hw = np.zeros((n, 2), np.float32)
    status = np.zeros((n,), np.int32)
    if n:
        lib.mgdt_load_batch(
            _paths(paths), n, imgsz, fill,
            imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            hw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), int(nthreads))
    return imgs, hw, status


def _take(ptr: int, h: int, w: int) -> np.ndarray:
    """Copy a malloc'd (h, w, 3) buffer of the library into numpy and free it."""
    try:
        return np.ctypeslib.as_array((ctypes.c_uint8 * (h * w * 3)).from_address(ptr)
                                     ).reshape(h, w, 3).copy()
    finally:
        get_lib().mgdt_free(ptr)


def decode(path) -> np.ndarray:
    """The (h, w, 3) uint8 BGR image `cv2.imread(path)` gives. Raises
    `UnsupportedFormat` for a format the port does not decode and
    `DecodeError` for a file it cannot read."""
    check_format(path)
    out, h, w = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
    st = get_lib().mgdt_decode(str(path).encode(), ctypes.byref(out), ctypes.byref(h),
                               ctypes.byref(w))
    if st != OK:
        raise DecodeError(path, st)
    return _take(out.value, h.value, w.value)


def decode_batch(paths: Sequence, nthreads: int = 8) -> List[Optional[np.ndarray]]:
    """`decode` over `paths` on a thread pool: a BGR image per path, or a
    `DecodeError` in its place where the file could not be read. Raises
    `UnsupportedFormat` before decoding anything."""
    for p in paths:
        check_format(p)
    n = len(paths)
    if not n:
        return []
    outs = (ctypes.c_void_p * n)()
    hs, ws, status = ((ctypes.c_int * n)() for _ in range(3))
    get_lib().mgdt_decode_batch(_paths(paths), n, outs, hs, ws, status, int(nthreads))
    return [_take(outs[i], hs[i], ws[i]) if status[i] == OK else DecodeError(paths[i], status[i])
            for i in range(n)]
