"""Dataset utilities: the image header reader, label verification with its
hash-validated cache, and dataset YAML resolution; the counterparts of
`mgdt_yolo_tpu/data/utils.py`'s `get_hash`, `exif_size`,
`segments2boxes`, `verify_image_label`, `scan_labels` and
`check_det_dataset`, without PIL, cv2 or PyYAML.

Where the JAX package opens an image with PIL to verify it and read its
EXIF-corrected size, the port reads the header itself (`image_header`):
JPEG (SOF0-SOF2, the APP1 EXIF orientation), PNG (the IHDR, then every
chunk's CRC up to IEND, as PIL's `verify` walks them), BMP and GIF (whose
size JAX reads before it refuses the format). Any other file is corrupt.

The label checks, messages, counts (missing, found, empty, corrupt) and
the `.cache` sidecar (`CACHE_VERSION`, the same hash and record layout)
are JAX's, so either package reads the other's cache. One difference:
JAX rewrites a JPEG that lacks its end marker in place, through PIL; the
port has no encoder and does not write into a dataset, so it leaves the
file as it is, and its decoder takes what is there (ROADMAP queue 3).
"""
from __future__ import annotations

import hashlib
import logging
import os
import struct
import zlib
from multiprocessing.pool import ThreadPool
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.dataset_yaml import yaml_load

LOGGER = logging.getLogger(__name__)

# the JAX package's image-extension set and cache version
IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
CACHE_VERSION = "mgdt-tpu-1.0"
# the JPEG frame headers the reader takes: baseline, extended, progressive
_JPEG_SOF = (0xC0, 0xC1, 0xC2)


def get_hash(paths: List[str]) -> str:
    """One hash of a path list: their total size and joined names, as the
    JAX `get_hash` computes it."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.sha256(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def _exif_orientation(app1: bytes) -> Optional[int]:
    """The Orientation tag (274) of an APP1 EXIF payload, None without one."""
    if len(app1) < 14 or app1[:6] != b"Exif\0\0":
        return None
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or len(tiff) < 8 or struct.unpack(order + "H", tiff[2:4])[0] != 42:
        return None
    ifd = struct.unpack(order + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return None
    for k in range(struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * k
        if e + 12 > len(tiff):
            break
        tag, typ = struct.unpack(order + "HH", tiff[e:e + 4])
        if tag == 274:
            return struct.unpack(order + "H", tiff[e + 8:e + 10])[0] if typ == 3 else None
    return None


def _jpeg_header(f) -> Tuple[int, int, Optional[int]]:
    """(w, h, orientation) from the markers before a JPEG's frame header."""
    orientation = None
    f.seek(2)
    while True:
        b = f.read(1)
        if not b:
            raise ValueError("truncated JPEG header")
        if b != b"\xff":
            raise ValueError("no JPEG marker found")
        m = f.read(1)
        while m == b"\xff":
            m = f.read(1)
        if not m:
            raise ValueError("truncated JPEG header")
        marker = m[0]
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker in (0xD9, 0xDA):
            raise ValueError("no JPEG frame header before the scan")
        raw = f.read(2)
        if len(raw) < 2:
            raise ValueError("truncated JPEG header")
        length = struct.unpack(">H", raw)[0]
        body = f.read(length - 2)
        if len(body) < length - 2:
            raise ValueError("truncated JPEG header")
        if marker == 0xE1 and orientation is None:
            orientation = _exif_orientation(body)
        elif marker in _JPEG_SOF:
            h, w = struct.unpack(">HH", body[1:5])
            return w, h, orientation
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"unsupported JPEG process (SOF{marker - 0xC0})")


def _png_header(f) -> Tuple[int, int]:
    """(w, h) from the IHDR, after every chunk's CRC up to IEND was checked,
    as PIL's `verify` checks them."""
    f.seek(8)
    size = None
    while True:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError("truncated PNG file")
        length, cid = struct.unpack(">I", head[:4])[0], head[4:]
        data = f.read(length)
        crc = f.read(4)
        if len(data) < length or len(crc) < 4:
            raise ValueError("truncated PNG file")
        if zlib.crc32(cid + data) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file (bad CRC in {cid.decode('latin-1')!r})")
        if cid == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
            size = (w, h)
        if cid == b"IEND":
            if size is None:
                raise ValueError("PNG without IHDR")
            return size


def image_header(path) -> Tuple[str, int, int, Optional[int]]:
    """(format, w, h, EXIF orientation or None) of an image file, from its
    header; raises ValueError for a file that is not a readable image."""
    with open(path, "rb") as f:
        sig = f.read(12)
        if sig[:2] == b"\xff\xd8":
            return ("jpeg", *_jpeg_header(f))
        if sig[:8] == b"\x89PNG\r\n\x1a\n":
            return ("png", *_png_header(f), None)
        if sig[:2] == b"BM":
            f.seek(14)
            hdr = f.read(12)
            if len(hdr) < 12:
                raise ValueError("truncated BMP header")
            if struct.unpack("<I", hdr[:4])[0] == 12:
                w, h = struct.unpack("<HH", hdr[4:8])
            else:
                w, h = struct.unpack("<ii", hdr[4:12])
            return "bmp", w, abs(h), None
        if sig[:6] in (b"GIF87a", b"GIF89a"):
            w, h = struct.unpack("<HH", sig[6:10])
            return "gif", w, h, None
    raise ValueError(f"cannot identify image file {str(path)!r}")


def exif_size(path) -> Tuple[int, int]:
    """The (w, h) of an image file corrected by its EXIF orientation, as the
    JAX `exif_size` corrects it (swapped for orientations 6 and 8)."""
    _, w, h, orientation = image_header(path)
    return (h, w) if orientation in (6, 8) else (w, h)


def segments2boxes(segments: List[np.ndarray]) -> np.ndarray:
    """Polygon segments -> normalized xywh boxes."""
    boxes = []
    for s in segments:
        x, y = s[:, 0], s[:, 1]
        boxes.append([(x.min() + x.max()) / 2, (y.min() + y.max()) / 2,
                      x.max() - x.min(), y.max() - y.min()])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def verify_image_label(img_path: str, label_path: str, num_cls: Optional[int] = None):
    """Verify one image/label pair, as the JAX `verify_image_label` does.

    Returns (record | None, nm, nf, ne, ncorrupt, msg): record = {im_file,
    shape (h, w), cls (n,), xywh (n, 4) normalized} for a healthy pair,
    None for a corrupt one (counted, not fatal). Checks: a readable header
    and its EXIF size, >= 10 px, a known format, a JPEG's end marker (a
    missing one is logged, the file left as it is), 5-column normalized
    labels (polygon rows folded to boxes), the class range, duplicate rows
    removed."""
    nm = nf = ne = nc_bad = 0
    msg = ""
    try:
        fmt, w, h, orientation = image_header(img_path)
        if orientation in (6, 8):  # the JAX `exif_size`
            w, h = h, w
        assert h > 9 and w > 9, f"image size {w}x{h} <10 pixels"
        assert fmt in IMG_FORMATS, f"invalid image format {fmt}"
        if fmt in ("jpg", "jpeg"):
            with open(img_path, "rb") as f:
                f.seek(-2, 2)
                if f.read() != b"\xff\xd9":
                    msg = f"{img_path}: corrupt JPEG (no end marker), decoded as it is"

        lp = Path(label_path)
        if lp.is_file():
            nf = 1
            rows = [line.split() for line in lp.read_text().strip().splitlines()
                    if line.strip()]
            if any(len(r) > 6 for r in rows):  # polygon rows -> boxes
                classes = np.asarray([r[0] for r in rows], np.float32)
                segs = [np.asarray(r[1:], np.float32).reshape(-1, 2) for r in rows]
                lb = np.concatenate([classes.reshape(-1, 1), segments2boxes(segs)], 1)
            else:
                lb = np.asarray(rows, np.float32).reshape(-1, 5)
            if len(lb):
                assert lb.shape[1] == 5, f"labels require 5 columns, got {lb.shape[1]}"
                assert (lb[:, 1:] <= 1).all(), "non-normalized coordinates"
                assert (lb >= 0).all(), "negative label values"
                if num_cls is not None:
                    assert int(lb[:, 0].max()) < num_cls, \
                        f"class {int(lb[:, 0].max())} exceeds nc={num_cls}"
                _, idx = np.unique(lb, axis=0, return_index=True)
                if len(idx) < len(lb):
                    lb = lb[np.sort(idx)]
                    msg = f"{img_path}: duplicate labels removed"
            else:
                ne = 1
                lb = np.zeros((0, 5), np.float32)
        else:
            nm = 1
            lb = np.zeros((0, 5), np.float32)
        rec = {"im_file": str(img_path), "shape": (h, w),
               "cls": lb[:, 0].copy(), "xywh": lb[:, 1:5].copy()}
        return rec, nm, nf, ne, nc_bad, msg
    except Exception as e:
        return None, nm, nf, ne, 1, f"{img_path}: ignoring corrupt image/label: {e}"


def scan_labels(im_files: List[str], label_files: List[str], cache_path: Path,
                num_cls: Optional[int] = None, workers: int = 8) -> List[Dict]:
    """The hash-validated label scan of the JAX `scan_labels`: the sidecar
    cache where its version and file-set hash match, else every pair
    verified on a thread pool and the cache rewritten. Corrupt pairs are
    dropped with a warning."""
    want_hash = get_hash(list(label_files) + list(im_files))
    try:
        cache = np.load(str(cache_path), allow_pickle=True).item()
        if cache.get("version") == CACHE_VERSION and cache.get("hash") == want_hash:
            LOGGER.info(f"dataset: loaded label cache {cache_path} "
                        f"({len(cache['labels'])} images)")
            return cache["labels"]
    except (FileNotFoundError, OSError, ValueError, AttributeError):
        pass

    with ThreadPool(max(1, workers)) as pool:
        results = pool.starmap(verify_image_label,
                               [(im, lb, num_cls) for im, lb in zip(im_files, label_files)])
    labels, msgs = [], []
    nm = nf = ne = ncorrupt = 0
    for rec, m, f, e, c, msg in results:
        nm += m
        nf += f
        ne += e
        ncorrupt += c
        if rec is not None:
            labels.append(rec)
        if msg:
            msgs.append(msg)
    for m in msgs[:10]:
        LOGGER.warning(m)
    LOGGER.info(f"dataset scan: {nf} labels, {nm + ne} backgrounds, {ncorrupt} corrupt")
    cache = {"labels": labels, "hash": want_hash, "version": CACHE_VERSION,
             "results": (nf, nm, ne, ncorrupt, len(im_files)), "msgs": msgs}
    try:
        np.save(str(cache_path), cache)
        cache_path.with_suffix(cache_path.suffix + ".npy").rename(cache_path)
        LOGGER.info(f"dataset: new label cache {cache_path}")
    except OSError:
        LOGGER.warning(f"cache dir not writeable: {cache_path.parent}")
    return labels


def check_det_dataset(data) -> Dict:
    """A dataset YAML, a directory or a dict resolved into split paths and
    `names`, as the JAX `check_det_dataset` resolves it (nothing is
    downloaded)."""
    if isinstance(data, dict):
        d = dict(data)
    else:
        p = Path(str(data))
        if p.suffix in (".yaml", ".yml") and p.is_file():
            d = yaml_load(p)
            d.setdefault("path", str(p.parent))
        elif p.is_dir():
            d = {"path": str(p), "train": ".", "val": ".", "names": {0: "0"}}
        else:
            raise FileNotFoundError(f"dataset {data!r} not found (nothing is downloaded)")
    root = Path(d.get("path", "."))
    for split in ("train", "val", "test"):
        if d.get(split):
            if not isinstance(d[split], str):
                raise ValueError(f"dataset split {split}={d[split]!r} must be one path")
            sp = root / d[split] if not Path(d[split]).is_absolute() else Path(d[split])
            d[split] = str(sp)
    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    d["names"] = names or {i: str(i) for i in range(int(d.get("nc", 1)))}
    d["nc"] = len(d["names"])
    return d
