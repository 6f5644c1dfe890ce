"""The port's BMP and TIFF decoders, and its header reader over every suffix
of `IMG_FORMATS`, against cv2 and the JAX package, on the CPU.

* BMP and TIFF: `native.decode` (and `decode_mem`, `load_batch`) against
  `cv2.imread(path)`, bit for bit: lossless formats through the same integer
  arithmetic. The BMP files are built here byte by byte (PIL writes 40-byte
  headers only, and no RLE); the TIFF files by PIL, by cv2 and by a small
  writer here (tiles, planar configuration 2, big-endian 16 bits, the
  horizontal predictor, 16-bit palettes, MinIsWhite). A variant that
  `cv2.imread` refuses (a TIFF oriented 5-8, which cv2 5.0 cannot read)
  must be refused too.
* Headers: `image_header`, `verify_image_label` and `scan_labels`' cache
  against JAX's (PIL's) over a dataset of jpg, png, bmp, tif, tiff and webp
  files: the same records, counts and messages.
"""
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from mgdt_yolo_tpu.data import utils as JU
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.data import utils as PU
from test_torch_dataset import scene
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _rng(tag: str):
    return np.random.default_rng(zlib.crc32(tag.encode()))


# ---------------------------------------------------------------------------
# BMP files, byte by byte
# ---------------------------------------------------------------------------

def _rle8(idx: np.ndarray) -> bytes:
    """RLE8 of (h, w) palette indices, bottom row first: runs of equal
    pixels, absolute runs (>= 3 pixels), a delta over a stretch of index 0
    when one is long enough, an end of line after each row, the end of the
    bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            if row[x] == 0 and x + 4 <= w and not row[x:x + 4].any():
                k = 4
                while x + k < w and row[x + k] == 0 and k < 255:
                    k += 1
                if x + k < w:  # a delta moves on; the pixels skipped take index 0
                    out += bytes([0, 2, k, 0])
                    x += k
                    continue
            k = 1
            while x + k < w and row[x + k] == row[x] and k < 255:
                k += 1
            if k >= 2:
                out += bytes([k, row[x]])
                x += k
                continue
            k = 1
            while x + k < w and k < 255 and (x + k + 1 >= w or row[x + k] != row[x + k + 1]):
                k += 1
            if k >= 3:
                out += bytes([0, k]) + bytes(row[x:x + k].tolist()) + (b"\0" if k & 1 else b"")
            else:
                out += b"".join(bytes([1, v]) for v in row[x:x + k])
            x += k
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def _rle4(idx: np.ndarray) -> bytes:
    """RLE4 of (h, w) 4-bit palette indices, bottom row first: runs of two
    alternating indices, absolute runs, an end of line after each row."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            a, b = row[x], row[x + 1] if x + 1 < w else row[x]
            k = 1
            while x + k < w and k < 255 and row[x + k] == (a if k % 2 == 0 else b):
                k += 1
            if k >= 4 or x + k >= w:
                out += bytes([k, (a << 4) | b])
                x += k
                continue
            k = min(w - x, 9)
            vals = list(row[x:x + k]) + ([0] if k & 1 else [])
            packed = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, len(vals), 2))
            out += bytes([0, k]) + packed + (b"\0" if len(packed) & 1 else b"")
            x += k
        out += b"\0\0"
    return bytes(out) + b"\0\1"


def bmp_bytes(img: np.ndarray, bpp: int, header: int = 40, top_down: bool = False,
              rle: bool = False, clrused: int = 0, bitfields=None) -> bytes:
    """A BMP of a BGR image: `bpp` 1/4/8 through a palette of the image's
    colours (quantised to 2/16/256), 16 as 5-5-5 (or 5-6-5 with bit
    fields), 24, or 32 with an alpha byte; `header` 12, 40, 108 or 124
    bytes; RLE4/RLE8 where `rle`; `bitfields` the masks of a BI_BITFIELDS
    file."""
    h, w = img.shape[:2]
    rng = _rng(f"bmp{bpp}{header}")
    pal = None
    if bpp <= 8:
        k = clrused or (1 << bpp)
        pal = rng.integers(0, 256, (k, 3), dtype=np.uint8)
        idx = rng.integers(0, k, (h, w)).astype(np.uint8)
        idx[h // 3:h // 2, : w // 2] = idx[0, 0]  # runs for RLE
        idx[h // 2, :w // 2] = 0  # a delta for RLE8
    if rle:
        data = _rle8(idx) if bpp == 8 else _rle4(idx)
    else:
        rows = []
        for r in (range(h) if top_down else range(h - 1, -1, -1)):
            if bpp == 1:
                row = np.packbits(idx[r]).tobytes()
            elif bpp == 4:
                v = np.concatenate([idx[r], [0] * (w & 1)]).astype(np.uint8)
                row = ((v[0::2] << 4) | v[1::2]).astype(np.uint8).tobytes()
            elif bpp == 8:
                row = idx[r].tobytes()
            elif bpp == 16:
                b, g, rr = (img[r, :, c].astype(np.uint16) for c in range(3))
                v = (rr >> 3) << 11 | (g >> 2) << 5 | b >> 3 if bitfields else \
                    (rr >> 3) << 10 | (g >> 3) << 5 | b >> 3
                row = v.astype("<u2").tobytes()
            elif bpp == 24:
                row = img[r].tobytes()
            else:
                alpha = rng.integers(0, 256, (w, 1), dtype=np.uint8)
                row = np.concatenate([img[r], alpha], 1).tobytes()
            rows.append(row + b"\0" * (-len(row) % 4))
        data = b"".join(rows)
    comp = (2 if bpp == 4 else 1) if rle else (3 if bitfields else 0)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
        palette = b"".join(bytes(p) for p in pal) if pal is not None else b""
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, comp,
                           len(data), 2835, 2835, clrused, 0)
        if header > 40:
            masks = bitfields or (0, 0, 0, 0)
            info += struct.pack("<IIII", *masks) + b"\0" * (header - 56)
        palette = b"".join(bytes(p) + b"\0" for p in pal) if pal is not None else b""
        if bitfields and header == 40:
            palette = struct.pack("<III", *bitfields[:3])
    off = 14 + len(info) + len(palette)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info + palette + data


BMP_CASES = {
    "os2-1bit": dict(bpp=1, header=12), "os2-4bit": dict(bpp=4, header=12),
    "os2-8bit": dict(bpp=8, header=12), "os2-24bit": dict(bpp=24, header=12),
    "1bit": dict(bpp=1), "4bit": dict(bpp=4), "8bit": dict(bpp=8),
    "8bit-clrused-40": dict(bpp=8, clrused=40), "4bit-clrused-5": dict(bpp=4, clrused=5),
    "16bit-555": dict(bpp=16), "16bit-565-bitfields": dict(bpp=16, bitfields=(0xF800, 0x7E0, 0x1F)),
    "24bit": dict(bpp=24), "24bit-top-down": dict(bpp=24, top_down=True),
    "8bit-top-down": dict(bpp=8, top_down=True), "32bit": dict(bpp=32),
    "32bit-bitfields": dict(bpp=32, bitfields=(0xFF0000, 0xFF00, 0xFF, 0)),
    "v4-24bit": dict(bpp=24, header=108), "v5-24bit": dict(bpp=24, header=124),
    "v4-8bit": dict(bpp=8, header=108),
    "v4-32bit-bitfields": dict(bpp=32, header=108, bitfields=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "v5-32bit-bitfields": dict(bpp=32, header=124, bitfields=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "rle8": dict(bpp=8, rle=True), "rle4": dict(bpp=4, rle=True),
    "rle8-clrused-20": dict(bpp=8, rle=True, clrused=20),
}


# ---------------------------------------------------------------------------
# TIFF files: a small writer for what PIL and cv2 do not write
# ---------------------------------------------------------------------------

def _lzw(data: bytes) -> bytes:
    """TIFF's LZW (MSB first, codes widening one code early, a clear code
    before the table fills)."""
    bits, out, acc, nacc = 9, bytearray(), 0, 0

    def emit(code, width):
        nonlocal acc, nacc
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8

    table, nxt = {bytes([i]): i for i in range(256)}, 258
    emit(256, bits)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w], bits)
        table[wc], nxt = nxt, nxt + 1
        if nxt >= (1 << bits) and bits < 12:
            bits += 1
        if nxt >= 4093:
            emit(256, bits)
            table, nxt, bits = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([c])
    if w:
        emit(table[w], bits)
        nxt += 1
        if nxt >= (1 << bits) and bits < 12:
            bits += 1
    emit(257, bits)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        k = 1
        while i + k < n and data[i + k] == data[i] and k < 128:
            k += 1
        if k >= 3:
            out += bytes([(257 - k) & 255, data[i]])
            i += k
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_bytes(samples: np.ndarray, photometric: int, bps: int = None, order: str = "<",
               planar: int = 1, tile=None, rows_per_strip: int = None, compression: int = 1,
               predictor: int = 1, orientation: int = None, extra: int = None,
               cmap: np.ndarray = None) -> bytes:
    """A TIFF of (h, w, spp) samples (uint8, or uint16 for 16 bits; values
    below 2**bps for 1-4 bits), laid out in strips or `tile` (tw, th)
    tiles, contiguous or planar, compressed and predicted as asked."""
    h, w, spp = samples.shape
    bps = bps or samples.dtype.itemsize * 8
    planes = spp if planar == 2 else 1
    cspp = 1 if planar == 2 else spp
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = -(-w // tw), -(-h // th)
    chunks = []
    for p in range(planes):
        plane = samples[..., p:p + 1] if planar == 2 else samples
        for ty in range(down):
            for tx in range(across):
                block = plane[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw].astype(np.int64)
                if tile:  # tiles are whole, padded with zeros
                    block = np.pad(block, [(0, th - block.shape[0]), (0, tw - block.shape[1]),
                                           (0, 0)])
                rows = block.reshape(block.shape[0], -1)
                if predictor == 2:
                    rows = rows.copy()
                    rows[:, cspp:] = (rows[:, cspp:] - rows[:, :-cspp]) % (1 << bps)
                if bps == 16:
                    raw = rows.astype(order + "u2").tobytes()
                elif bps == 8:
                    raw = rows.astype(np.uint8).tobytes()
                else:  # packed MSB first, each row from a byte boundary
                    bits = ((rows[..., None] >> np.arange(bps - 1, -1, -1)) & 1).reshape(
                        rows.shape[0], -1)
                    raw = np.packbits(bits.astype(np.uint8), axis=1).tobytes()
                chunks.append({1: raw, 5: _lzw(raw), 8: zlib.compress(raw),
                               32773: _packbits(raw)}[compression])
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if orientation:
        tags[274] = (3, [orientation])
    if extra is not None:
        tags[338] = (3, [extra])
    if cmap is not None:
        tags[320] = (3, [int(v) for v in cmap.T.reshape(-1)])
    data = bytearray(b"II*\0" if order == "<" else b"MM\0*")
    data += b"\0\0\0\0"
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + b"\0" * (len(c) & 1)
    if tile:
        tags.update({322: (4, [tw]), 323: (4, [th]), 324: (4, offsets),
                     325: (4, [len(c) for c in chunks])})
    else:
        tags.update({278: (4, [th]), 273: (4, offsets), 279: (4, [len(c) for c in chunks])})
    fmt = {3: "H", 4: "I"}
    extra_data, entries = bytearray(), []
    ifd_at = len(data)
    table_end = ifd_at + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        typ, vals = tags[tag]
        packed = struct.pack(order + fmt[typ] * len(vals), *vals)
        if len(packed) <= 4:
            entries.append(struct.pack(order + "HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0"))
        else:
            entries.append(struct.pack(order + "HHII", tag, typ, len(vals),
                                       table_end + len(extra_data)))
            extra_data += packed + b"\0" * (len(packed) & 1)
    data[4:8] = struct.pack(order + "I", ifd_at)
    data += struct.pack(order + "H", len(tags)) + b"".join(entries) + b"\0\0\0\0" + extra_data
    return bytes(data)


def _samples(tag, h, w, spp, bps):
    return _rng(tag).integers(0, 1 << bps, (h, w, spp)).astype(np.uint16 if bps == 16
                                                                  else np.uint8)


def _palette16(bps):
    """A 16-bit colour map with entries such as 0x0100, where cutting to the
    high byte and scaling by 255/65535 differ."""
    k = 1 << bps
    return (_rng(f"cmap{bps}").integers(0, 256, (k, 3)) << 8) | \
        _rng(f"cmap-lo{bps}").integers(0, 2, (k, 3))


def _tiff_own(case, h, w):
    rgb8, rgb16 = _samples(case, h, w, 3, 8), _samples(case, h, w, 3, 16)
    return {
        "rgb-tiles-contig": lambda: tiff_bytes(rgb8, 2, tile=(16, 16)),
        "rgb-tiles-planar-deflate": lambda: tiff_bytes(rgb8, 2, planar=2, tile=(16, 32),
                                                       compression=8),
        "rgb-strips-planar-lzw": lambda: tiff_bytes(rgb8, 2, planar=2, rows_per_strip=5,
                                                    compression=5),
        "rgb-strips-lzw-predictor": lambda: tiff_bytes(rgb8, 2, rows_per_strip=7,
                                                       compression=5, predictor=2),
        "rgb16-be-deflate-predictor": lambda: tiff_bytes(rgb16, 2, order=">", compression=8,
                                                         predictor=2, rows_per_strip=4),
        "rgb16-le-packbits": lambda: tiff_bytes(rgb16, 2, compression=32773),
        "rgba8-unassociated": lambda: tiff_bytes(_samples(case, h, w, 4, 8), 2, extra=2),
        "rgba8-associated-tiles": lambda: tiff_bytes(_samples(case, h, w, 4, 8), 2, extra=1,
                                                     tile=(16, 16), compression=5),
        "rgba16-unassociated-be": lambda: tiff_bytes(_samples(case, h, w, 4, 16), 2, extra=2,
                                                     order=">"),
        "grey16-be-predictor": lambda: tiff_bytes(_samples(case, h, w, 1, 16), 1, order=">",
                                                  compression=5, predictor=2),
        "grey1-miniswhite-tiles": lambda: tiff_bytes(_samples(case, h, w, 1, 1), 0, bps=1,
                                                     tile=(16, 16)),
        "grey8-miniswhite-packbits": lambda: tiff_bytes(_samples(case, h, w, 1, 8), 0,
                                                        compression=32773),
        "grey-alpha": lambda: tiff_bytes(_samples(case, h, w, 2, 8), 1, extra=2),
        "palette8-cmap16": lambda: tiff_bytes(_samples(case, h, w, 1, 8), 3,
                                              cmap=_palette16(8)),
        "palette4-cmap8-tiles": lambda: tiff_bytes(_samples(case, h, w, 1, 4), 3, bps=4,
                                                   tile=(16, 16),
                                                   cmap=_rng("c4").integers(0, 256, (16, 3))),
        "rgb-orientation-2": lambda: tiff_bytes(rgb8, 2, orientation=2),
        "rgb-orientation-3": lambda: tiff_bytes(rgb8, 2, orientation=3, compression=8),
        "rgb-orientation-4": lambda: tiff_bytes(rgb8, 2, orientation=4),
    }[case]()


TIFF_OWN = ["rgb-tiles-contig", "rgb-tiles-planar-deflate", "rgb-strips-planar-lzw",
            "rgb-strips-lzw-predictor", "rgb16-be-deflate-predictor", "rgb16-le-packbits",
            "rgba8-unassociated", "rgba8-associated-tiles", "rgba16-unassociated-be",
            "grey16-be-predictor", "grey1-miniswhite-tiles",
            "grey8-miniswhite-packbits", "grey-alpha", "palette8-cmap16", "palette4-cmap8-tiles",
            "rgb-orientation-2", "rgb-orientation-3", "rgb-orientation-4"]
PIL_MODES = ["1", "L", "P", "LA", "RGB", "RGBA", "I;16", "I;16B"]
PIL_COMPRESSIONS = ["raw", "tiff_lzw", "tiff_deflate", "packbits", "tiff_adobe_deflate"]


def _write_tiff(path: Path, case: str, h: int = 37, w: int = 45):
    from PIL import Image
    kind, _, rest = case.partition(":")
    img = scene(h, w, zlib.crc32(case.encode()) % 97)
    if kind == "pil":
        mode, comp = rest.split("/")
        if mode.startswith("I;16"):
            im = Image.fromarray(_samples(case, h, w, 1, 16)[..., 0]).convert(mode)
        else:
            im = Image.fromarray(img[..., ::-1]).convert(mode)
        im.save(path, compression=comp)
    elif kind == "cv2":
        if rest == "rgb16":
            cv2.imwrite(str(path), _samples(case, h, w, 3, 16))
        elif rest == "bgra8":
            cv2.imwrite(str(path), _samples(case, h, w, 4, 8))
        else:  # lzw with the horizontal predictor, 8 rows a strip
            cv2.imwrite(str(path), img, [cv2.IMWRITE_TIFF_COMPRESSION, 5,
                                         cv2.IMWRITE_TIFF_PREDICTOR, 2,
                                         cv2.IMWRITE_TIFF_ROWSPERSTRIP, 8])
    else:
        path.write_bytes(_tiff_own(rest, h, w))


TIFF_CASES = [f"pil:{m}/{c}" for m in PIL_MODES for c in PIL_COMPRESSIONS] + \
    ["cv2:rgb16", "cv2:bgra8", "cv2:lzw-predictor"] + [f"own:{c}" for c in TIFF_OWN]


# ---------------------------------------------------------------------------
# the decoder against cv2.imread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [f"bmp:{c}" for c in BMP_CASES] + [f"tiff:{c}"
                                                                     for c in TIFF_CASES])
def test_bmp_and_tiff_decode_to_cv2_bits(tmp_path, case):
    """Every variant decodes to `cv2.imread`'s bits: `decode`, `decode_mem`,
    `decode_batch`, and `load_batch`'s canvas at the image's own size."""
    fmt, _, name = case.partition(":")
    if fmt == "bmp":
        path = tmp_path / "a.bmp"
        h, w = (29, 37) if "rle" not in name else (23, 31)
        path.write_bytes(bmp_bytes(scene(h, w, len(name)), **BMP_CASES[name]))
    else:
        path = tmp_path / "a.tif"
        _write_tiff(path, name)
    want = cv2.imread(str(path))
    assert want is not None, case
    got = native.decode(path)
    np.testing.assert_array_equal(got, want, err_msg=case)
    np.testing.assert_array_equal(native.decode_mem(path.read_bytes()), want, err_msg=case)
    np.testing.assert_array_equal(native.decode_batch([path, path], 2)[1], want, err_msg=case)
    size = max(want.shape[:2])
    imgs, hw, status = native.load_batch([path], size, 114, 1)
    assert status[0] == native.OK and tuple(hw[0]) == want.shape[:2]
    np.testing.assert_array_equal(imgs[0][:want.shape[0], :want.shape[1]], want[..., ::-1])


@pytest.mark.parametrize("case", ["orientation-5", "orientation-6", "orientation-7",
                                  "orientation-8", "grey4", "grey2", "palette2"])
def test_tiffs_cv2_refuses_are_refused(tmp_path, case):
    """cv2 5.0 cannot read a TIFF whose orientation transposes it, nor 2- or
    4-bit samples without a palette, nor 2-bit palettes (`imread` gives
    None); the port refuses them too, as files it cannot read, so both
    loaders skip them."""
    path = tmp_path / "a.tif"
    kind, _, arg = case.partition("-")
    if kind == "orientation":
        data = tiff_bytes(_samples("o", 9, 13, 3, 8), 2, orientation=int(arg))
    else:
        bps = int(case[-1])
        data = tiff_bytes(_samples("g", 9, 13, 1, bps), 3 if kind.startswith("palette") else 1,
                          bps=bps, cmap=np.arange(3 << bps).reshape(-1, 3)
                          if kind.startswith("palette") else None)
    path.write_bytes(data)
    assert cv2.imread(str(path)) is None
    with pytest.raises(native.DecodeError):
        native.decode(path)


@pytest.mark.parametrize("compression,name", [(7, "JPEG"), (34887, "LERC"), (3, "CCITT G3"),
                                              (50000, "Zstd")])
def test_other_tiff_compressions_raise_naming_them(tmp_path, compression, name):
    path = tmp_path / "a.tif"
    path.write_bytes(tiff_bytes(_samples("c", 8, 8, 3, 8), 2).replace(
        struct.pack("<HHI", 259, 3, 1) + struct.pack("<H", 1),
        struct.pack("<HHI", 259, 3, 1) + struct.pack("<H", compression)))
    with pytest.raises(native.UnsupportedFormat, match=f"compression {compression} \\({name}\\)"):
        native.decode(path)
    with pytest.raises(native.UnsupportedFormat, match=name):
        native.decode_batch([path])


def test_ycbcr_and_cmyk_tiffs_raise_naming_them(tmp_path):
    for photometric, name in ((5, "CMYK"), (6, "YCbCr")):
        path = tmp_path / f"p{photometric}.tif"
        path.write_bytes(tiff_bytes(_samples("p", 8, 8, 4 if photometric == 5 else 3, 8),
                                    photometric))
        with pytest.raises(native.UnsupportedFormat, match=name):
            native.decode(path)


def test_webp_alone_is_refused_by_name(tmp_path):
    """WebP, the last suffix of `IMG_FORMATS`, is decoded to cv2's bits
    (`tests/test_torch_webp.py` holds the decoder whole): the decoder now
    takes every suffix, and refuses another by name."""
    from PIL import Image
    Image.fromarray(scene(20, 20, 0)).save(tmp_path / "a.webp")
    np.testing.assert_array_equal(native.decode(tmp_path / "a.webp"),
                                  cv2.imread(str(tmp_path / "a.webp")))
    assert set(native.DECODED_SUFFIXES) == PU.IMG_FORMATS
    with pytest.raises(native.UnsupportedFormat, match="gif"):
        native.decode(tmp_path / "a.gif")


# ---------------------------------------------------------------------------
# headers, label records and the cache against JAX's
# ---------------------------------------------------------------------------

def _mixed_dataset(root: Path):
    """images/ with a file of each suffix (some EXIF- or IFD-oriented, one
    too small, one broken, one GIF renamed .jpg) and labels/ with YOLO rows
    for most of them."""
    from PIL import Image, TiffImagePlugin
    img_dir, lab_dir = root / "images", root / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    files = {}
    for i, (name, kind) in enumerate([
            ("a.jpg", "jpg"), ("b.png", "png"), ("c.bmp", "bmp"), ("d.tif", "tif"),
            ("e.tiff", "tiff6"), ("f.webp", "webp"), ("g.webp", "webp-lossy-exif8"),
            ("h.tif", "tif-orient5"), ("i.bmp", "bmp-small"), ("j.tiff", "broken"),
            ("k.jpg", "gif"), ("l.webp", "webp-rgba")]):
        img = scene(24 + 3 * i, 40 - 2 * i, i)
        p = img_dir / name
        pil = Image.fromarray(img[..., ::-1])
        if kind in ("jpg", "png", "bmp"):
            cv2.imwrite(str(p), img)
        elif kind == "bmp-small":
            cv2.imwrite(str(p), img[:8, :30])
        elif kind.startswith("tif"):
            info = TiffImagePlugin.ImageFileDirectory_v2()
            if kind != "tif":
                info[274] = int(kind[-1])
            pil.save(p, tiffinfo=info, compression="tiff_lzw")
        elif kind == "webp":
            pil.save(p, lossless=True)
        elif kind == "webp-rgba":
            pil.convert("RGBA").save(p)
        elif kind == "webp-lossy-exif8":
            ex = Image.Exif()
            ex[274] = 8
            pil.save(p, quality=70, exif=ex.tobytes())
        elif kind == "broken":
            p.write_bytes(b"II*\0" + b"\xff" * 6)
        elif kind == "gif":
            pil.save(p, format="GIF")
        if i % 4 != 3:
            (lab_dir / f"{p.stem}.txt").write_text(f"{i % 3} 0.5 0.5 0.25 0.5\n0 0.2 0.3 0.1 0.1\n")
        files[name] = p
    return [str(files[k]) for k in sorted(files)], \
        [str(lab_dir / f"{Path(k).stem}.txt") for k in sorted(files)]


def test_headers_records_and_cache_equal_jax(tmp_path):
    """`image_header`'s size, `verify_image_label`'s records, counts and
    messages, and `scan_labels`' cache equal JAX's over jpg, png, bmp, tif,
    tiff and webp files (EXIF/IFD orientations among them), a file too
    small, a broken TIFF and a GIF (whose format JAX refuses)."""
    from PIL import Image
    ims, labs = _mixed_dataset(tmp_path)
    for im, lab in zip(ims, labs):
        got, want = PU.verify_image_label(im, lab, 3), JU.verify_image_label(im, lab, 3)
        assert got[1:5] == want[1:5], (im, got, want)
        assert (got[0] is None) == (want[0] is None), (im, got[5], want[5])
        if want[0] is not None:
            assert got[0]["shape"] == want[0]["shape"], im
            np.testing.assert_array_equal(got[0]["xywh"], want[0]["xywh"])
            fmt, w, h, _ = PU.image_header(im)
            with Image.open(im) as pil:
                assert (fmt, w, h) == (pil.format.lower(), *pil.size), im
                assert PU.exif_size(im) == JU.exif_size(pil), im
    ours = PU.scan_labels(ims, labs, tmp_path / "ours.cache", num_cls=3, workers=2)
    theirs = JU.scan_labels(ims, labs, tmp_path / "theirs.cache", num_cls=3, workers=2)
    assert [r["im_file"] for r in ours] == [r["im_file"] for r in theirs]
    assert [r["shape"] for r in ours] == [r["shape"] for r in theirs]
    a = np.load(tmp_path / "ours.cache", allow_pickle=True).item()
    b = np.load(tmp_path / "theirs.cache", allow_pickle=True).item()
    assert a["hash"] == b["hash"] and a["version"] == b["version"]
    assert [r["im_file"] for r in a["labels"]] == [r["im_file"] for r in b["labels"]]
    assert {k: v for k, v in a.items() if k in ("nm", "nf", "ne", "nc")} == \
        {k: v for k, v in b.items() if k in ("nm", "nf", "ne", "nc")}
    # each reads the other's cache
    assert len(PU.scan_labels(ims, labs, tmp_path / "theirs.cache", num_cls=3)) == len(theirs)


def test_jpeg_frames_without_huffman_tables_get_the_standard_ones():
    """An AVI1-style Motion JPEG frame (no DHT) gains JPEG's standard tables
    before its scan, as ffmpeg inserts them: libjpeg reads the result as it
    reads the frame with its own standard tables; a frame with tables is
    left as it is."""
    img = scene(40, 56, 3)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    full = buf.tobytes()
    assert native.jpeg_standard_dht(full) is None
    stripped = bytearray()
    p = 2
    stripped += full[:2]
    while True:
        m, n = full[p + 1], struct.unpack(">H", full[p + 2:p + 4])[0]
        if m == 0xDA:
            stripped += full[p:]
            break
        if m != 0xC4:
            stripped += full[p:p + 2 + n]
        p += 2 + n
    fixed = native.jpeg_standard_dht(bytes(stripped))
    assert fixed is not None and fixed.count(b"\xff\xc4") == 1 and len(fixed) > len(stripped)
    want = cv2.imdecode(np.frombuffer(full, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(fixed, np.uint8), cv2.IMREAD_COLOR),
                                  want)
