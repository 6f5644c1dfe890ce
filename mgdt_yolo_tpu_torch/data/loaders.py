"""Inference sources: image and video files, directories and globs, HTTP
Motion JPEG streams, screenshots and in-memory images; the counterparts of
`LoadImagesAndVideos`, `LoadStreams`, `LoadScreenshots`, `LoadPilAndNumpy`
and `load_inference_source` in `mgdt_yolo_tpu/data/loaders.py`.

Each source yields {img (BGR uint8 HWC), path, frame_idx, is_video} in the
JAX loader's order, and a video's or a stream's items also `fps`. A source
gives its items undecoded (`entries()`, lazily) and decodes a list of them
together (`decode(entries)`): the predictor decodes a batch at a time, so a
long video never sits in memory whole; iterating a source does the same,
8 items at a time.

* Images (jpg, jpeg, png, bmp, tif, tiff, webp) are decoded by the port's
  decoder (`native`); one it cannot read is logged and skipped, as JAX
  skips it.
* Videos (`native.video`): Motion JPEG in AVI, MP4/MOV/M4V and Matroska;
  GIF; MPEG-4 Part 2 (the `mp4v` of cv2's writer and the JAX package's
  `save=True`, Xvid/DivX/ffmpeg AVIs, Matroska); VP8 in WebM and Matroska.
  JAX's `vid_stride` rule: each item is the last of `vid_stride` frames
  grabbed, so at stride 3 the first is frame 2; `frame_idx` counts the
  items. The predictor decodes a batch of frames on its helper thread while
  the batch before runs (`decode`); an inter-coded video's reader decodes
  forward from where it stopped. A video ends, with a warning, at the first
  frame that cannot be read, as JAX's ends where `retrieve` fails; on a
  machine without a CUDA device that is a Motion JPEG video's first frame.
  Other codecs, coding tools and containers raise `UnsupportedVideo`,
  naming them and why.
* Streams: `http://` and `https://` Motion JPEG (`multipart/x-mixed-replace`,
  as IP cameras serve it), read with `http.client`, at the fps cv2 reports
  for them (25); webcams (digits) and `rtsp://`/`rtmp://` raise
  `NotImplementedError`, naming what is missing.
* Screenshots: JAX's `LoadScreenshots`, through `mss` (imported in the
  constructor; an `ImportError` where it is absent, as JAX's).
"""
from __future__ import annotations

import glob
import http.client
import logging
from itertools import islice
from pathlib import Path
from typing import Dict, Iterator, List, Union
from urllib.parse import urlsplit

import numpy as np

from .. import native
from ..native.video import VID_FORMATS, VideoReader
from .utils import IMG_FORMATS

LOGGER = logging.getLogger(__name__)

CHUNK = 8  # items decoded together when a source is iterated
STREAM_FPS = 25.0  # what cv2 (ffmpeg's mpjpeg demuxer) reports for an HTTP Motion JPEG stream
STREAM_TIMEOUT = 30.0


class Source:
    """What every source shares: `entries()` its items undecoded, lazily,
    `decode(entries)` them decoded (in memory already by default), and
    iteration over the decoded items, `chunk` at a time."""

    chunk = CHUNK

    def entries(self) -> Iterator[Dict]:
        return iter(self.items)

    def decode(self, entries: List[Dict]) -> List[Dict]:
        return entries

    def __iter__(self) -> Iterator[Dict]:
        it = self.entries()
        while True:
            chunk = list(islice(it, self.chunk))
            if not chunk:
                return
            yield from self.decode(chunk)


class LoadImagesAndVideos(Source):
    """The image and video files of a file, a directory (searched at any
    depth) or a glob, sorted, as the JAX loader lists them. Every video is
    opened here (its index read), so one the port does not read raises
    before anything runs."""

    def __init__(self, source: Union[str, Path], vid_stride: int = 1):
        p = Path(str(source))
        if p.is_dir():
            files = sorted(str(f) for f in p.rglob("*"))
        elif p.is_file():
            files = [str(p)]
        else:
            files = sorted(glob.glob(str(source), recursive=True))
        self.files = [f for f in files
                      if Path(f).suffix[1:].lower() in IMG_FORMATS | VID_FORMATS]
        if not self.files:
            raise FileNotFoundError(f"no images/videos found in {source!r}")
        self.readers: Dict[str, VideoReader] = {}
        self._unreadable: Dict[str, str] = {}
        for f in self.files:
            if Path(f).suffix[1:].lower() in VID_FORMATS:
                try:
                    self.readers[f] = VideoReader(f)
                except native.DecodeError as e:
                    self._unreadable[f] = str(e)
        self.vid_stride = vid_stride
        self._ended: Dict[str, int] = {}

    @staticmethod
    def decode_batch(files: List[str], nthreads: int = 8) -> List[Dict]:
        """The items of image `files` (decoded together), skipping, with a
        warning, each file the decoder cannot read."""
        out = []
        for f, img in zip(files, native.decode_batch(files, nthreads)):
            if isinstance(img, native.DecodeError):
                LOGGER.warning(f"unreadable image {f} ({img})")
                continue
            out.append({"img": img, "path": f, "frame_idx": 0, "is_video": False})
        return out

    def entries(self) -> Iterator[Dict]:
        """Each image as {path}, each video frame the stride keeps as {path,
        frame_idx, is_video, fps, frame (its index in the file)}."""
        s = self.vid_stride
        for f in self.files:
            if f in self._unreadable:
                LOGGER.warning(f"unreadable video {f} ({self._unreadable[f]})")
            elif f in self.readers:
                r = self.readers[f]
                for k in range(r.frames // s):
                    yield {"path": f, "frame_idx": k, "is_video": True, "fps": r.fps or 30,
                           "frame": k * s + s - 1}
            else:
                yield {"path": f}

    def decode(self, entries: List[Dict]) -> List[Dict]:
        """`entries` decoded together, in order: images on the decoder's
        threads, each video's frames a batch at a time (nvJPEG); a video
        ends at its first frame that cannot be read."""
        files = [e["path"] for e in entries if "frame" not in e]
        images = {it["path"]: it for it in self.decode_batch(files)} if files else {}
        frames: Dict[str, List[Dict]] = {}
        for e in entries:
            if "frame" in e and e["frame"] < self._ended.get(e["path"], 1 << 62):
                frames.setdefault(e["path"], []).append(e)
        imgs = {}
        for path, es in frames.items():
            for e, img in zip(es, self.readers[path].read([e["frame"] for e in es])):
                if isinstance(img, native.DecodeError):
                    LOGGER.warning(f"{path}: the video ends at frame {e['frame']}, which cannot "
                                   f"be read ({img})")
                    self._ended[path] = e["frame"]
                    break
                imgs[path, e["frame"]] = img
        out = []
        for e in entries:
            if "frame" not in e:
                if e["path"] in images:
                    out.append(images[e["path"]])
            elif (e["path"], e["frame"]) in imgs:
                out.append({"img": imgs[e["path"], e["frame"]], "path": e["path"],
                            "frame_idx": e["frame_idx"], "is_video": True, "fps": e["fps"]})
        return out


class LoadStreams(Source):
    """An HTTP(S) Motion JPEG stream, read until it ends; the path of its
    items is `stream_<source>`, as JAX names it. Webcams and RTSP/RTMP
    raise. Iterated a frame at a time, as it comes."""

    chunk = 1

    def __init__(self, source: str = "0", vid_stride: int = 1):
        self.source = int(source) if str(source).isdigit() else source
        self.vid_stride = vid_stride
        self._ended = False
        if isinstance(self.source, int):
            raise NotImplementedError(
                f"the webcam stream {self.source} needs a V4L2 device, which the card's host "
                "does not have (ROADMAP queue 1, Blocked)")
        scheme = urlsplit(str(self.source)).scheme.lower()
        if scheme not in ("http", "https"):
            raise NotImplementedError(
                f"the {scheme} stream {self.source!r} needs RTP and an H.264 decoder, which the "
                "port does not have (ROADMAP queue 1, Blocked: no encoder on either machine "
                "writes an H.264 stream to hold a decoder to); HTTP Motion JPEG streams are read")

    def _parts(self) -> Iterator[bytes]:
        """Each JPEG of the stream, as the server sends it."""
        url = urlsplit(str(self.source))
        conn_type = http.client.HTTPSConnection if url.scheme.lower() == "https" \
            else http.client.HTTPConnection
        conn = conn_type(url.hostname, url.port, timeout=STREAM_TIMEOUT)
        try:
            try:
                conn.request("GET", (url.path or "/") + (f"?{url.query}" if url.query else ""))
                resp = conn.getresponse()
            except OSError as e:
                raise ConnectionError(f"failed to open stream {self.source!r}") from e
            ctype = resp.getheader("Content-Type", "")
            if resp.status != 200 or "multipart" not in ctype.lower():
                raise ConnectionError(f"failed to open stream {self.source!r} (HTTP "
                                      f"{resp.status}, {ctype or 'no content type'})")
            boundary = next((p.split("=", 1)[1].strip().strip('"') for p in ctype.split(";")
                             if p.strip().lower().startswith("boundary=")), None)
            if not boundary:
                raise ConnectionError(f"the stream {self.source!r} names no boundary")
            marker = (boundary if boundary.startswith("--") else "--" + boundary).encode()
            line = resp.readline()
            while line:
                if not line.strip().startswith(marker):
                    line = resp.readline()
                    continue
                if line.strip().endswith(b"--"):
                    return
                length = None
                while True:  # the part's headers
                    h = resp.readline()
                    if not h or not h.strip():
                        break
                    name, _, value = h.decode("latin-1").partition(":")
                    if name.strip().lower() == "content-length":
                        length = int(value.strip())
                if length is None:  # the part runs to the next boundary
                    data = bytearray()
                    line = resp.readline()
                    while line and not line.strip().startswith(marker):
                        data += line
                        line = resp.readline()
                    yield bytes(data).rstrip(b"\r\n")
                    continue
                data = resp.read(length)
                if len(data) < length:
                    return
                yield data
                line = resp.readline()
        finally:
            conn.close()

    def entries(self) -> Iterator[Dict]:
        """{data (the JPEG), path, frame_idx, is_video, fps}: the last of
        every `vid_stride` frames, as JAX's grabs and retrieves them."""
        parts, i = self._parts(), 0
        path = f"stream_{self.source}"
        self._ended = False
        while not self._ended:
            data = None
            for _ in range(self.vid_stride):
                data = next(parts, None)
                if data is None:
                    return
            yield {"data": data, "path": path, "frame_idx": i, "is_video": True,
                   "fps": STREAM_FPS}
            i += 1

    def decode(self, entries: List[Dict]) -> List[Dict]:
        """`entries` decoded together (nvJPEG); the stream ends, with a
        warning, at the first frame that cannot be read."""
        imgs = native.decode_mem_batch([e["data"] for e in entries], names=[
            f"{e['path']} frame {e['frame_idx']}" for e in entries])
        out = []
        for e, img in zip(entries, imgs):
            if self._ended:
                break
            if isinstance(img, native.DecodeError):
                LOGGER.warning(f"the stream {self.source!r} ends at a frame that cannot be "
                               f"read ({img})")
                self._ended = True
                continue
            out.append({"img": img, **{k: e[k] for k in ("path", "frame_idx", "is_video",
                                                         "fps")}})
        return out


class LoadScreenshots(Source):
    """`source='screen [screen] [left top width height]'` captured with mss,
    as JAX's `LoadScreenshots`; `max_frames` 0 is endless."""

    chunk = 1

    def __init__(self, source: str, max_frames: int = 0):
        try:
            import mss
        except ImportError as e:
            raise ImportError("screenshot capture requires the 'mss' package") from e
        _, *params = str(source).split()
        self.screen, left, top, width, height = 0, None, None, None, None
        if len(params) == 1:
            self.screen = int(params[0])
        elif len(params) == 4:
            left, top, width, height = (int(x) for x in params)
        elif len(params) == 5:
            self.screen, left, top, width, height = (int(x) for x in params)
        self.sct = mss.mss()
        mon = self.sct.monitors[self.screen]
        self.monitor = {
            "left": mon["left"] if left is None else mon["left"] + left,
            "top": mon["top"] if top is None else mon["top"] + top,
            "width": width or mon["width"],
            "height": height or mon["height"]}
        self.max_frames = max_frames

    def entries(self) -> Iterator[Dict]:
        i = 0
        while not self.max_frames or i < self.max_frames:
            im = np.array(self.sct.grab(self.monitor))[:, :, :3]  # BGRA -> BGR
            yield {"img": im, "path": f"screen_{self.screen}", "frame_idx": i,
                   "is_video": True, "fps": 30}
            i += 1


class LoadPilAndNumpy(Source):
    """In-memory images: numpy arrays (BGR uint8 HWC) and PIL images
    (converted to RGB, then to BGR), named `array<i>.jpg` as JAX names
    them."""

    def __init__(self, source):
        items = source if isinstance(source, (list, tuple)) else [source]
        self.items = []
        for i, it in enumerate(items):
            if hasattr(it, "mode"):  # PIL
                arr = np.asarray(it.convert("RGB"))[..., ::-1]
            else:
                arr = np.asarray(it)
            self.items.append({"img": arr, "path": f"array{i}.jpg", "frame_idx": 0,
                               "is_video": False})

    def __iter__(self):
        return iter(self.items)


def load_inference_source(source, vid_stride: int = 1):
    """The loader of `source`, sniffed as the JAX package sniffs it: arrays
    and PIL images in memory, `screen...`, digits and stream URLs, else a
    file, directory or glob."""
    if isinstance(source, np.ndarray) or hasattr(source, "mode") or \
            (isinstance(source, (list, tuple)) and source and
             (isinstance(source[0], np.ndarray) or hasattr(source[0], "mode"))):
        return LoadPilAndNumpy(source)
    s = str(source)
    if s.startswith("screen"):
        return LoadScreenshots(s)
    if s.isdigit() or s.startswith(("rtsp://", "rtmp://", "http://", "https://")):
        return LoadStreams(s, vid_stride)
    return LoadImagesAndVideos(source, vid_stride)
