"""Inference sources: image files, directories and globs, and in-memory
images; the counterparts of `LoadImagesAndVideos`, `LoadPilAndNumpy` and
`load_inference_source` in `mgdt_yolo_tpu/data/loaders.py`.

Each source yields {img (BGR uint8 HWC), path, frame_idx, is_video}. Files
are decoded by the port's decoder (`native`); one it cannot read is logged
and skipped, as JAX skips it, and a format it does not decode (videos,
`bmp`, `tif`, `tiff`, `webp`) raises, naming it. Streams and screenshots
raise: they need a video decoder and a display, which the card's host does
not have (ROADMAP queue 1).
"""
from __future__ import annotations

import glob
import logging
from pathlib import Path
from typing import Dict, Iterator, List, Union

import numpy as np

from .. import native
from .utils import IMG_FORMATS

LOGGER = logging.getLogger(__name__)

VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv",
               "webm"}
NO_VIDEO = ("{} needs a video decoder, which the card's host does not have; video, stream "
            "and screenshot sources are not ported (ROADMAP queue 1)")


class LoadImagesAndVideos:
    """The image files of a file, a directory (searched at any depth) or a
    glob, sorted, as the JAX loader lists them; videos among them raise.
    `decode_batch(files)` decodes a list of them on the decoder's threads."""

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
        for f in self.files:
            if Path(f).suffix[1:].lower() in VID_FORMATS:
                raise NotImplementedError(NO_VIDEO.format(f"the video {f}"))
            native.check_format(f)
        self.vid_stride = vid_stride

    @staticmethod
    def decode_batch(files: List[str], nthreads: int = 8) -> List[Dict]:
        """The items of `files` (decoded together), skipping, with a
        warning, each file the decoder cannot read."""
        out = []
        for f, img in zip(files, native.decode_batch(files, nthreads)):
            if isinstance(img, native.DecodeError):
                LOGGER.warning(f"unreadable image {f} ({img})")
                continue
            out.append({"img": img, "path": f, "frame_idx": 0, "is_video": False})
        return out

    def __iter__(self) -> Iterator[Dict]:
        for f in self.files:
            yield from self.decode_batch([f], 1)


class LoadPilAndNumpy:
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
    """The loader of `source`, sniffed as the JAX package sniffs it:
    arrays and PIL images in memory, else a file, directory or glob;
    screenshots and streams raise."""
    if isinstance(source, np.ndarray) or hasattr(source, "mode") or \
            (isinstance(source, (list, tuple)) and source and
             (isinstance(source[0], np.ndarray) or hasattr(source[0], "mode"))):
        return LoadPilAndNumpy(source)
    s = str(source)
    if s.startswith("screen"):
        raise NotImplementedError(NO_VIDEO.format(f"the screenshot source {s!r}"))
    if s.isdigit() or s.startswith(("rtsp://", "rtmp://", "http://", "https://")):
        raise NotImplementedError(NO_VIDEO.format(f"the stream {s!r}"))
    return LoadImagesAndVideos(source, vid_stride)
