"""The image decoder of the port's data pipeline, bound with ctypes.

A counterpart of the JAX package's `mgdt_yolo_tpu/native`: `src/host_loader.cpp`
decodes JPEG with nvJPEG on the card and PNG (zlib), BMP and TIFF on the host
(WebP by `src/host_webp.cpp`, built into the same library), and
keeps the JAX loader's long-side bilinear resize, its paste into the
114-filled RGB canvas, its status codes and its thread pool. It is built
at first use into `_build/` (`utils/build.py`); a build that fails raises
with the compiler's message, and nothing falls back to another decoder.

* `load_batch(paths, imgsz)`: the JAX `load_batch`: canvases, pasted sizes
  and a status per image (`OK`, or a code for the caller to redo through
  the Python path: `ERR_EXIF` for a JPEG with an EXIF orientation and
  `ERR_FORMAT` for a WebP, as JAX declines them).
* `decode(path)` / `decode_batch(paths)`: the full-size BGR image
  `cv2.imread` gives, EXIF orientation applied.

The host augmentation's hot loops, `src/host_augment.cpp`, are built the
same way and bound by `data/imgproc.py`.

* `decode_mem(data)` / `decode_mem_batch(datas)`: `decode` of a file's
  bytes in memory (a video's JPEG frames, `native/video.py`); JPEG frames
  without Huffman tables get the standard ones (`jpeg_standard_dht`).

Formats: every suffix of `IMG_FORMATS`: JPEG (where the machine has a CUDA
device), PNG, BMP, TIFF and WebP (lossy, lossless, extended, animated: the
first frame), each to `cv2.imread`'s bits (JPEG within nvJPEG's IDCT), a
WebP's EXIF orientation applied as cv2 applies it. A TIFF whose compression
or colour model the decoder does not take (JPEG-in-TIFF, CMYK, YCbCr,
floating point) raises `UnsupportedFormat`, naming that, and so does a path
of another suffix; `decode` raises `DecodeError` for a file it cannot read
(a WebP cv2 refuses, truncated or corrupt, among them). Videos the port
does not read raise `UnsupportedVideo` (`native/video.py`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import _lazy

# status codes (keep in sync with host_loader.cpp)
OK = 0
ERR_OPEN = -1
ERR_EXIF = -2
ERR_DECODE = -3
ERR_FORMAT = -4
ERR_COLORSPACE = -5
ERR_NO_JPEG = -6
ERR_UNSUPPORTED = -7
STATUS = {OK: "ok", ERR_OPEN: "cannot open", ERR_EXIF: "EXIF-rotated JPEG",
          ERR_DECODE: "cannot decode", ERR_FORMAT: "neither JPEG, PNG, BMP, TIFF nor WebP",
          ERR_COLORSPACE: "CMYK JPEG", ERR_NO_JPEG: "a JPEG, and JPEG decoding (nvJPEG) "
                                                    "needs a CUDA device",
          ERR_UNSUPPORTED: "a TIFF compression or colour model the decoder does not take"}
DECODED_SUFFIXES = ("jpg", "jpeg", "png", "bmp", "tif", "tiff", "webp")
# the TIFF compressions and photometric interpretations the decoder takes,
# and the names of some it does not (for the message)
TIFF_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
TIFF_OTHER_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4", 6: "old JPEG",
                           7: "JPEG", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                           50000: "Zstd", 50001: "WebP"}
TIFF_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette", 4: "mask",
                    5: "separated (CMYK)", 6: "YCbCr", 8: "CIELab"}


class DecodeError(RuntimeError):
    """A file the decoder could not read; `status` holds its code."""

    def __init__(self, path, status: int):
        super().__init__(f"{path}: {STATUS.get(status, status)}")
        self.path, self.status = str(path), status


class UnsupportedFormat(NotImplementedError):
    """A suffix outside `IMG_FORMATS`, or a TIFF variant, the decoder does
    not take."""


class UnsupportedVideo(NotImplementedError):
    """A video container, codec, coding tool or source the port does not
    read: the message names the file, the container, the codec and why
    (`native.video.reason`: H.264 and HEVC are ROADMAP queue 1's "Blocked",
    for want of an encoder that writes a stream to hold a decoder to; the
    rest are its next video items)."""


def check_format(path) -> None:
    """Raise `UnsupportedFormat`, naming it, for a suffix the decoder does
    not take."""
    suffix = Path(str(path)).suffix[1:].lower()
    if suffix not in DECODED_SUFFIXES:
        raise UnsupportedFormat(f"{path}: the port decodes {', '.join(DECODED_SUFFIXES)} only; "
                                f"{suffix or 'a file without a suffix'} is not decoded")


def tiff_tags(data: bytes) -> dict:
    """{tag: first value} of the SHORT and LONG entries of the first IFD of
    a TIFF's (or an EXIF payload's) bytes; raises ValueError where they are
    not a TIFF or are cut short."""
    import struct
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise ValueError("not a TIFF header")
    ifd = struct.unpack(order + "I", data[4:8])[0]
    if ifd + 2 > len(data):
        raise ValueError("truncated TIFF header")
    tags = {}
    for k in range(struct.unpack(order + "H", data[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * k
        if e + 12 > len(data):
            raise ValueError("truncated TIFF directory")
        tag, typ = struct.unpack(order + "HH", data[e:e + 4])
        if typ == 3:
            tags[tag] = struct.unpack(order + "H", data[e + 8:e + 10])[0]
        elif typ == 4:
            tags[tag] = struct.unpack(order + "I", data[e + 8:e + 12])[0]
    return tags


def unsupported_tiff(path, data: bytes) -> UnsupportedFormat:
    """The error of a TIFF the decoder refused (`ERR_UNSUPPORTED`), naming its
    compression, colour model or sample format."""
    try:
        tags = tiff_tags(data)
    except ValueError:
        tags = {}
    comp, photo = tags.get(259, 1), tags.get(262, 1)
    if comp not in TIFF_COMPRESSIONS:
        what = f"compression {comp} ({TIFF_OTHER_COMPRESSIONS.get(comp, 'unknown')})"
    elif photo not in (0, 1, 2, 3):
        what = f"photometric interpretation {photo} ({TIFF_PHOTOMETRIC.get(photo, 'unknown')})"
    else:
        what = (f"sample format {tags.get(339, 1)}, {tags.get(258, 1)} bits a sample, "
                f"predictor {tags.get(317, 1)}")
    return UnsupportedFormat(f"{path}: a TIFF with {what}, which the port does not decode "
                             "(it takes uncompressed, LZW, Deflate and PackBits TIFFs of grey, "
                             "palette, RGB and RGBA samples)")


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
        ("mgdt_decode_mem_batch", None, (paths, ctypes.POINTER(ctypes.c_int64),
                                         i32, ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int), i32)),
        ("mgdt_jpeg_standard_dht", ptr, (ptr, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64))),
    ))


def available() -> bool:
    """Whether the decoder library loads (JAX `native/__init__.py:96`; the
    port's builds at first use and raises where it cannot)."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


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
    if st == ERR_UNSUPPORTED:
        raise unsupported_tiff(path, Path(str(path)).read_bytes())
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
    out = [_take(outs[i], hs[i], ws[i]) if status[i] == OK else DecodeError(paths[i], status[i])
           for i in range(n)]
    for i in range(n):
        if status[i] == ERR_UNSUPPORTED:
            raise unsupported_tiff(paths[i], Path(str(paths[i])).read_bytes())
    return out


def decode_mem(data: bytes, name: str = "<memory>") -> np.ndarray:
    """`decode` of a file's bytes (`name` for the error): the BGR image, or
    `DecodeError`."""
    img = decode_mem_batch([data], 1, [name])[0]
    if isinstance(img, DecodeError):
        raise img
    return img


def decode_mem_batch(datas: Sequence[bytes], nthreads: int = 8,
                     names: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    """`decode_mem` over `datas` on a thread pool, together: a BGR image
    each, or a `DecodeError` in its place (`names` label them)."""
    n = len(datas)
    names = names or [f"<memory {i}>" for i in range(n)]
    if not n:
        return []
    datas = [bytes(d) for d in datas]
    ptrs = (ctypes.c_char_p * n)(*datas)  # the bytes objects' own buffers
    sizes = (ctypes.c_int64 * n)(*[len(d) for d in datas])
    outs = (ctypes.c_void_p * n)()
    hs, ws, status = ((ctypes.c_int * n)() for _ in range(3))
    get_lib().mgdt_decode_mem_batch(ptrs, sizes, n, outs, hs, ws, status, int(nthreads))
    out = [_take(outs[i], hs[i], ws[i]) if status[i] == OK else DecodeError(names[i], status[i])
           for i in range(n)]
    for i in range(n):
        if status[i] == ERR_UNSUPPORTED:
            raise unsupported_tiff(names[i], bytes(datas[i]))
    return out


def jpeg_standard_dht(data: bytes) -> Optional[bytes]:
    """A JPEG frame's bytes with JPEG's standard Huffman tables inserted
    before its first scan, as the decoder inserts them where a Motion JPEG
    frame (AVI1 style) has none; None where it has its own."""
    n = ctypes.c_int64()
    lib = get_lib()
    ptr = lib.mgdt_jpeg_standard_dht(bytes(data), len(data), ctypes.byref(n))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.mgdt_free(ptr)


# the package's logger, as the JAX package's `native` imports `utils.LOGGER`
_LAZY = {"LOGGER": "..utils.settings"}
__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, _LAZY,
                                                   own=_lazy.own_names(globals()))
