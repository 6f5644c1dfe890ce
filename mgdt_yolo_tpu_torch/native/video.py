"""Video files for the port's inference sources and the predictor's writer,
bound with ctypes: the counterpart of what the JAX package does through
`cv2.VideoCapture` and `cv2.VideoWriter`.

`src/host_video.cpp` (g++ at first use, `utils/build.py`, name
`HOST_VIDEO`) demuxes AVI, MP4/MOV/M4V and Matroska/WebM files, decodes
GIFs, MPEG-4 Part 2 (`src/host_mpeg4.cpp`) and VP8 (`src/host_vp8.h`, the
WebP decoder's), and writes Motion JPEG into MP4 files. A Motion JPEG frame
is decoded by the image decoder (`native.decode_mem_batch`: nvJPEG on the
card, a batch at a time); GIF, MPEG-4 Part 2 and VP8 frames are decoded on
the host, each to the bits cv2's reading gives (ffmpeg's decoders, whose
4:2:0 frames swscale turns to BGR: `src/host_yuv.h`).

* `VideoReader(path)`: `frames` (the count cv2 reads), `fps` (what
  `cv2.CAP_PROP_FPS` reports), `size`; `read(indices)` decodes the frames
  of increasing source indices, a BGR image each, or a `DecodeError` in
  place of a frame that cannot be read. An inter-coded video (MPEG-4 Part
  2, VP8) keeps its decoder's state and decodes forward; an index before
  the last one read, or one past a later key frame, starts again from the
  key frame at or before it.
* `VideoWriter(path, fps, (w, h))`: `write(bgr)` appends a frame, encoded
  by the port's JPEG encoder (`utils.draw.encode_jpeg`); `release()`
  finishes the file. Its fps is the rational cv2's writer makes of it, so
  cv2 reads the file back at the same fps as the JAX package's.

Read: Motion JPEG (AVI, MP4/MOV, Matroska), GIF, MPEG-4 Part 2 Simple
Profile (the `mp4v` cv2's writer and so the JAX package's `save=True` write,
Xvid, DivX and ffmpeg AVIs, `V_MPEG4/ISO/*` Matroska) and VP8 (WebM,
Matroska). Not read, each raising `native.UnsupportedVideo` that names the
file, the container, the codec and the reason (`reason`): H.264 and HEVC
(ROADMAP queue 1, "Blocked": no encoder on either machine writes a stream to
hold a decoder to), VP9, AV1, MPEG-1/2 and the MPEG-4 tools outside the Simple
Profile (B-VOPs, quarter-pel, GMC, interlace, data partitioning, ...:
ROADMAP queue 1), fragmented MP4, interlaced two-field Motion JPEG, laced
Matroska blocks, and the `asf`, `wmv`, `mpeg`, `mpg` and `ts` containers. A
file that is not a video it can parse gives a `DecodeError`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np

from . import DecodeError, UnsupportedVideo, decode_mem_batch

VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv",
               "webm"}
NOT_READ = {"asf", "wmv", "mpeg", "mpg", "ts"}
BLOCKED = ("ROADMAP queue 1, Blocked: no encoder on either machine writes an H.264 or HEVC "
           "stream to hold a decoder to")
NOT_YET = "ROADMAP queue 1: a next video item, not ported yet"
V_OK, V_ERR_PARSE, V_UNSUPPORTED, V_END = 0, -3, -7, -8  # host_video.cpp's status codes
K_MJPEG, K_GIF, K_MPEG4, K_VP8 = 0, 1, 2, 3  # its kinds of video


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..utils.build import HOST_VIDEO, load_library
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ip, lp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)
    return load_library(HOST_VIDEO, (
        ("mgdt_video_open", p, (ctypes.c_char_p, ip)),
        ("mgdt_video_describe", None, (p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                       i32)),
        ("mgdt_video_info", None, (p, ip, lp, ctypes.POINTER(ctypes.c_double), ip, ip)),
        ("mgdt_video_index", None, (p, p, p)),
        ("mgdt_video_gif_next", i32, (p, p)),
        ("mgdt_video_read", i32, (p, i64, ip, ip)),
        ("mgdt_video_copy", None, (p, p)),
        ("mgdt_video_close", None, (p,)),
        ("mgdt_mp4_open", p, (ctypes.c_char_p, i32, i32, i64, i64)),
        ("mgdt_mp4_write", i32, (p, p, i64)),
        ("mgdt_mp4_close", i32, (p,)),
    ))


def reason(container: str, codec: str, what: str) -> str:
    """Why the port does not read what it refuses: H.264 and HEVC have no
    stream to hold a decoder to; the rest waits in ROADMAP queue 1."""
    text = f"{container} {codec} {what}".lower()
    return BLOCKED if any(k in text for k in ("h.264", "hevc", "avc1", "hvc1", "hev1")) \
        else NOT_YET


def unsupported(path, container: str, codec: str, what: str) -> UnsupportedVideo:
    return UnsupportedVideo(f"{path}: {what} is not read by the port (container {container}, "
                            f"codec {codec or 'none named'}; {reason(container, codec, what)})")


class VideoReader:
    """A video file's frames; see the module's text. Raises
    `UnsupportedVideo` for what the port does not read and `DecodeError`
    for a file it cannot parse."""

    def __init__(self, path: Union[str, Path]):
        self.path = str(path)
        suffix = Path(self.path).suffix[1:].lower()
        if suffix in NOT_READ:
            raise unsupported(self.path, suffix, "", f"the {suffix} container")
        lib = _lib()
        status = ctypes.c_int()
        self._h = lib.mgdt_video_open(self.path.encode(), ctypes.byref(status))
        try:
            if status.value == V_UNSUPPORTED:
                raise unsupported(self.path, *self._describe())
            if status.value != V_OK:
                raise DecodeError(self.path, status.value)
            kind, n, fps = ctypes.c_int(), ctypes.c_int64(), ctypes.c_double()
            w, h = ctypes.c_int(), ctypes.c_int()
            lib.mgdt_video_info(self._h, ctypes.byref(kind), ctypes.byref(n), ctypes.byref(fps),
                                ctypes.byref(w), ctypes.byref(h))
            self.kind, self.frames, self.fps = kind.value, n.value, fps.value
            self.size = (w.value, h.value)
            if self.kind == K_MJPEG:
                self.offsets = np.zeros(self.frames, np.int64)
                self.sizes = np.zeros(self.frames, np.int64)
                lib.mgdt_video_index(self._h, self.offsets.ctypes.data, self.sizes.ctypes.data)
        except BaseException:
            self.close()
            raise
        if self.kind == K_MJPEG:  # the index is all a Motion JPEG reader keeps
            self.close()
        self._next = 0  # a GIF's next frame to compose

    def _describe(self) -> Tuple[str, str, str]:
        """The library's container, codec and message of the last refusal or error."""
        bufs = [ctypes.create_string_buffer(256) for _ in range(3)]
        _lib().mgdt_video_describe(self._h, *bufs, 256)
        return tuple(b.value.decode("latin-1") for b in bufs)

    def frame_bytes(self, indices: Sequence[int]) -> List[bytes]:
        """The JPEG bytes of Motion JPEG frames `indices`, read from the file."""
        with open(self.path, "rb") as f:
            out = []
            for i in indices:
                f.seek(int(self.offsets[i]))
                out.append(f.read(int(self.sizes[i])))
        return out

    def read(self, indices: Sequence[int], nthreads: int = 8) -> list:
        """Frames `indices` (increasing), BGR uint8 (h, w, 3) each, or a
        `DecodeError` in place of one that cannot be read."""
        names = [f"{self.path} frame {i}" for i in indices]
        if self.kind == K_MJPEG:
            return decode_mem_batch(self.frame_bytes(indices), nthreads, names)
        if self.kind in (K_MPEG4, K_VP8):
            return [self._read_inter(i, name) for i, name in zip(indices, names)]
        out, (w, h) = [], self.size
        for i, name in zip(indices, names):
            img = None
            while self._h and self._next <= i:
                buf = np.empty((h, w, 3), np.uint8)
                ok = _lib().mgdt_video_gif_next(self._h, buf.ctypes.data) == V_OK
                self._next += 1
                if not ok:
                    self.close()
                elif self._next == i + 1:
                    img = buf
            out.append(img if img is not None else DecodeError(name, V_ERR_PARSE))
        return out

    def _read_inter(self, index: int, name: str):
        """Frame `index` of an MPEG-4 Part 2 or VP8 video, or a `DecodeError`;
        a tool the port does not decode met in the stream raises
        `UnsupportedVideo`."""
        if not self._h:
            return DecodeError(name, V_ERR_PARSE)
        w, h = ctypes.c_int(), ctypes.c_int()
        st = _lib().mgdt_video_read(self._h, int(index), ctypes.byref(w), ctypes.byref(h))
        if st == V_UNSUPPORTED:
            container, codec, what = self._describe()
            raise unsupported(self.path, container, codec, what)
        if st != V_OK:
            return DecodeError(f"{name} ({self._describe()[2]})" if st == V_ERR_PARSE else name,
                               st)
        img = np.empty((h.value, w.value, 3), np.uint8)
        _lib().mgdt_video_copy(self._h, img.ctypes.data)
        return img

    def close(self):
        if getattr(self, "_h", None):
            _lib().mgdt_video_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # the interpreter is shutting down
            pass


def writer_rate(fps: float) -> Tuple[int, int]:
    """cv2's writer's frame rate as a fraction (rate, base): the fewest
    decimal places within 0.001 of `fps`."""
    rate, base = int(fps + 0.5), 1
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    return rate, base


class VideoWriter:
    """A Motion JPEG MP4 at `fps`, frames of `size` (w, h), the port's
    counterpart of `cv2.VideoWriter(path, fourcc, fps, size)`."""

    def __init__(self, path: Union[str, Path], fps: float, size: Tuple[int, int]):
        if not (fps > 0 and math.isfinite(fps)):
            raise ValueError(f"fps must be positive, got {fps}")
        self.path, self.size = str(path), (int(size[0]), int(size[1]))
        self.rate, self.base = writer_rate(float(fps))
        self._h = _lib().mgdt_mp4_open(self.path.encode(), *self.size, self.rate, self.base)
        if not self._h:
            raise OSError(f"cannot write the video {self.path}")

    def write(self, img: np.ndarray):
        """Append a BGR uint8 frame of the writer's size."""
        from ..utils.draw import encode_jpeg
        if img.shape[:2] != (self.size[1], self.size[0]):
            raise ValueError(f"{self.path}: a frame of {img.shape[1]}x{img.shape[0]}, the video "
                             f"is {self.size[0]}x{self.size[1]}")
        data = encode_jpeg(np.ascontiguousarray(img))
        if _lib().mgdt_mp4_write(self._h, data, len(data)) != 0:
            raise OSError(f"cannot write to the video {self.path}")

    def release(self):
        """Finish the file (idempotent)."""
        if self._h:
            h, self._h = self._h, None
            if _lib().mgdt_mp4_close(h) != 0:
                raise OSError(f"cannot finish the video {self.path}")
