"""The port's WebP decoder (`native/src/host_webp.cpp`) against cv2 and the
JAX package, on the CPU.

* `native.decode`, `decode_batch` and `decode_mem` against `cv2.imread`,
  bit for bit, on files made here by PIL and cv2 (lossy at several qualities
  and methods; lossless with palettes of 2 to 256 colours; 1x1, 1xN, Nx1 and
  odd sizes; RGBA; EXIF orientations 1-8 in an extended file; animations)
  and built here chunk by chunk (EXIF variants, animations whose first frame
  is smaller than the canvas and partly transparent); truncated and corrupt
  files are refused where cv2 refuses them, and where cv2 reads a corrupt
  stream, the port reads the same pixels.
* The committed fixtures (`native/fixtures/webp/`, written by
  `tests/torch_webp_fixtures.py` through libwebp's own encoder: the simple
  loop filter, sharpness, 2/4/8 token partitions, 1 and 4 segments, a
  filtered compressed `ALPH`, two full-detail 1080x1920 scenes) against cv2
  and their PNG twins (the scenes: the digests of cv2's reading, in
  `digests.json`), with the features each exercises read from its header.
* `load_batch`, the `DataLoader`'s batches over a WebP dataset,
  `LoadImagesAndVideos` and the classify dataset against the JAX package's.
* The port includes no libwebp header and links no libwebp.
"""
import io
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from mgdt_yolo_tpu import native as jax_native
from mgdt_yolo_tpu.data.build import DataLoader as JaxDataLoader
from mgdt_yolo_tpu.data.dataset import YOLODataset as JaxYOLODataset
from mgdt_yolo_tpu.data.loaders import LoadImagesAndVideos as JaxLoadImages
from mgdt_yolo_tpu.engine import classify as JCL
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS
from mgdt_yolo_tpu_torch.data.build import DataLoader
from mgdt_yolo_tpu_torch.data.dataset import YOLODataset
from mgdt_yolo_tpu_torch.data.loaders import LoadImagesAndVideos
from mgdt_yolo_tpu_torch.data.synthetic import synthetic_scene
from mgdt_yolo_tpu_torch.engine import classify as CL
from mgdt_yolo_tpu_torch.utils import build
from test_torch_dataset import label_rows, scene
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_webp_fixtures import SCENE, digest

FIXTURES = Path(native.__file__).parent / "fixtures" / "webp"


# ---------------------------------------------------------------------------
# files: PIL's and cv2's encoders, and a RIFF writer for what they cannot make
# ---------------------------------------------------------------------------

def smooth(h, w, seed, channels=3):
    """A seeded image with smooth structure and noise (what a camera gives)."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h // 8 + 2, w // 8 + 2, channels)).astype(np.float32)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, channels)
    return np.clip(img + r.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def pil_webp(arr, **kw) -> bytes:
    """`arr` (RGB or RGBA) saved by PIL as WebP under `kw`."""
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "WEBP", **kw)
    return b.getvalue()


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w, h, flags) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags) + struct.pack("<I", w - 1)[:3] +
                 struct.pack("<I", h - 1)[:3])


def chunks_of(data: bytes):
    """[(tag, payload)] of a RIFF file's top-level chunks."""
    out, i = [], 12
    while i + 8 <= len(data):
        n = struct.unpack("<I", data[i + 4:i + 8])[0]
        out.append((data[i:i + 4], data[i + 8:i + 8 + n]))
        i += 8 + n + (n & 1)
    return out


def image_chunks(data: bytes) -> list:
    """The ALPH, VP8 and VP8L chunks of a still file."""
    return [chunk(t, p) for t, p in chunks_of(data) if t in (b"ALPH", b"VP8 ", b"VP8L")]


def animation(canvas, frames, flags=0x12, bg=0):
    """An animated file: `frames` [(still file, x, y, w, h, ANMF flags)]."""
    le24 = lambda v: struct.pack("<I", v)[:3]  # noqa: E731
    body = [vp8x(*canvas, flags), chunk(b"ANIM", struct.pack("<IH", bg, 0))]
    for data, x, y, w, h, fl in frames:
        body.append(chunk(b"ANMF", le24(x // 2) + le24(y // 2) + le24(w - 1) + le24(h - 1) +
                          le24(100) + bytes([fl]) + b"".join(image_chunks(data))))
    return riff(body)


def exif(orientation, prefix=False, big_endian=True) -> bytes:
    """A bare TIFF header (as WebP's EXIF chunk holds it) with one
    Orientation tag; `prefix` puts JPEG's `Exif\\0\\0` before it."""
    o = ">" if big_endian else "<"
    tiff = (b"MM\0*" if big_endian else b"II*\0") + struct.pack(o + "I", 8) + \
        struct.pack(o + "H", 1) + struct.pack(o + "HHIHH", 0x112, 3, 1, orientation, 0) + \
        b"\0\0\0\0"
    return (b"Exif\0\0" if prefix else b"") + tiff


def cv2_read(path):
    """`cv2.imread`, None where it refuses the file (or raises)."""
    try:
        return cv2.imread(str(path))
    except cv2.error:
        return None


def port_read(data: bytes):
    try:
        return native.decode_mem(data)
    except native.DecodeError:
        return None


def assert_cv2_bits(tmp_path, data: bytes, name="a.webp"):
    """The port's three entry points give `cv2.imread`'s bits, or all refuse
    where it does."""
    p = tmp_path / name
    p.write_bytes(data)
    want = cv2_read(p)
    got = [port_read(data)]
    try:
        got.append(native.decode(p))
    except native.DecodeError as e:
        assert e.status in (native.ERR_DECODE, native.ERR_FORMAT)
        got.append(None)
    b = native.decode_batch([p, p], 2)
    got += [None if isinstance(x, native.DecodeError) else x for x in b]
    for g in got:
        if want is None:
            assert g is None, "cv2 refuses the file and the port reads it"
        else:
            assert g is not None, "cv2 reads the file and the port refuses it"
            assert g.shape == want.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(g, want)
    return want


# ---------------------------------------------------------------------------
# still images
# ---------------------------------------------------------------------------

SIZES = [(1, 1), (1, 9), (13, 1), (16, 16), (17, 33), (30, 20), (67, 45)]


@pytest.mark.parametrize("quality,method", [(5, 0), (50, 4), (90, 6), (100, 2)])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossy_matches_cv2(tmp_path, size, quality, method):
    img = smooth(*size, seed=size[0] * 100 + size[1])
    assert_cv2_bits(tmp_path, pil_webp(img, quality=quality, method=method))


@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossless_matches_cv2(tmp_path, size, method):
    img = smooth(*size, seed=size[0] * 100 + size[1] + 7)
    assert_cv2_bits(tmp_path, pil_webp(img, lossless=True, method=method))


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
def test_lossless_palettes_match_cv2(tmp_path, colours):
    """Colour indexing, with 8, 4 and 2 pixels bundled a byte at 2, 4 and 16
    colours and fewer."""
    r = np.random.default_rng(colours)
    for h, w in ((37, 29), (8, 61)):
        pal = r.integers(0, 256, (colours, 3), np.uint8)
        img = pal[r.integers(0, colours, (h, w))]
        assert_cv2_bits(tmp_path, pil_webp(img, lossless=True, method=4))


def test_cv2s_encoder_and_alpha_match_cv2(tmp_path):
    """cv2's own encoder (lossy, and lossless at quality 101), and RGBA
    files: cv2 drops alpha, and an `ALPH` chunk changes no colour."""
    img = smooth(45, 62, 3)
    for q in (1, 40, 95, 101):
        ok, enc = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])
        assert ok
        assert_cv2_bits(tmp_path, enc.tobytes())
    rgba = np.dstack([smooth(45, 62, 4), smooth(45, 62, 5, 1)])
    rgba[:10, :10, 3] = 0
    for kw in (dict(quality=60), dict(quality=95, alpha_quality=30), dict(lossless=True),
               dict(lossless=True, exact=True)):
        data = pil_webp(rgba, **kw)
        assert assert_cv2_bits(tmp_path, data).shape == (45, 62, 3)
    assert b"ALPH" in pil_webp(rgba, quality=60)


# ---------------------------------------------------------------------------
# the extended container: EXIF, animation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations_match_cv2(tmp_path, orientation):
    """A VP8X file with the EXIF flag turns as cv2 turns it (5-8 swap the
    sides), for a lossy and a lossless image, either byte order."""
    img = smooth(20, 31, orientation)
    for still in (pil_webp(img, quality=80), pil_webp(img, lossless=True)):
        for be in (True, False):
            data = riff([vp8x(31, 20, 0x08), *image_chunks(still),
                         chunk(b"EXIF", exif(orientation, big_endian=be))])
            want = assert_cv2_bits(tmp_path, data)
            assert want.shape[:2] == ((31, 20) if orientation >= 5 else (20, 31))


def test_exif_variants_match_cv2(tmp_path):
    """The orientation is read only where the VP8X flag says EXIF, from the
    first EXIF chunk, from a bare TIFF header (a `Exif\\0\\0` prefix gives
    none), before or after the image; a simple file's EXIF is not read."""
    img = smooth(20, 31, 9)
    im = image_chunks(pil_webp(img, quality=80))
    cases = {
        "flag unset": riff([vp8x(31, 20, 0), *im, chunk(b"EXIF", exif(6))]),
        "prefix": riff([vp8x(31, 20, 0x08), *im, chunk(b"EXIF", exif(6, prefix=True))]),
        "before image": riff([vp8x(31, 20, 0x08), chunk(b"EXIF", exif(6)), *im]),
        "first of two": riff([vp8x(31, 20, 0x08), *im, chunk(b"EXIF", exif(1)),
                              chunk(b"EXIF", exif(6))]),
        "simple file": riff([*im, chunk(b"EXIF", exif(6))]),
        "with ICCP and XMP": riff([vp8x(31, 20, 0x2c), chunk(b"ICCP", b"\0" * 31), *im,
                                   chunk(b"EXIF", exif(8)), chunk(b"XMP ", b"<x/>")]),
    }
    shapes = {k: assert_cv2_bits(tmp_path, v).shape[:2] for k, v in cases.items()}
    assert shapes == {"flag unset": (20, 31), "prefix": (20, 31), "before image": (31, 20),
                      "first of two": (20, 31), "simple file": (20, 31),
                      "with ICCP and XMP": (31, 20)}


def test_animations_read_their_first_frame_as_cv2(tmp_path):
    """An animation reads as its first frame on a zeroed canvas: a frame
    smaller than the canvas at an offset, with alpha between 1 and 254 (not
    blended), lossy with ALPH or lossless, whatever its flags and the
    background colour; PIL's own animations; an EXIF-oriented one."""
    r = np.random.default_rng(3)
    frame = np.dstack([smooth(10, 8, 1), r.integers(1, 255, (10, 8, 1), np.uint8)])
    other = pil_webp(smooth(30, 20, 2), lossless=True)
    for still in (pil_webp(frame, lossless=True, exact=True), pil_webp(frame, quality=70)):
        for fl in (0, 1, 2, 3):
            data = animation((20, 30), [(still, 4, 6, 8, 10, fl), (other, 0, 0, 20, 30, 0)],
                             bg=0xff102030)
            want = assert_cv2_bits(tmp_path, data)
            assert want.shape == (30, 20, 3) and not want[:6].any() and not want[:, 12:].any()
    frames = [smooth(24, 18, k) for k in range(3)]
    from PIL import Image
    for kw in (dict(lossless=True), dict(quality=60)):
        b = io.BytesIO()
        Image.fromarray(frames[0]).save(b, "WEBP", save_all=True, duration=50,
                                        append_images=[Image.fromarray(f) for f in frames[1:]],
                                        **kw)
        assert_cv2_bits(tmp_path, b.getvalue())
    still = pil_webp(frame, lossless=True)
    body = chunks_of(animation((20, 30), [(still, 4, 6, 8, 10, 0)]))
    turned = riff([vp8x(20, 30, 0x1a)] + [chunk(t, p) for t, p in body[1:]] +
                  [chunk(b"EXIF", exif(6))])
    assert assert_cv2_bits(tmp_path, turned).shape == (20, 30, 3)


def test_broken_animations_are_refused_as_cv2_refuses_them(tmp_path):
    still = pil_webp(smooth(10, 8, 1), lossless=True)
    cases = [animation((20, 30), [(still, 14, 6, 8, 10, 0)]),  # past the canvas
             riff([vp8x(20, 30, 0x12), chunk(b"ANIM", b"\0" * 6)]),  # no frame
             riff([vp8x(20, 30, 0x12)] + [chunk(t, p) for t, p in chunks_of(
                 animation((20, 30), [(still, 0, 0, 8, 10, 0)]))[2:]]),  # no ANIM
             animation((20, 30), [(still, 0, 0, 8, 10, 0)], flags=0x13)]  # a reserved flag
    for data in cases:
        assert assert_cv2_bits(tmp_path, data) is None


def test_a_canvas_cv2_raises_on_is_refused(tmp_path):
    """A known difference (ROADMAP queue 3): `cv2.imread` raises `cv2.error`
    for an animation whose canvas passes 2^20 a side or 2^30 pixels (its
    image-size limits), so JAX's loaders stop there; the port raises
    `DecodeError`, so its loaders skip the file. At 2^20 both read it."""
    still = pil_webp(np.zeros((1, 1, 3), np.uint8), lossless=True)
    for canvas in ((1, (1 << 20) + 1), ((1 << 15), (1 << 15) + 1)):
        p = tmp_path / "big.webp"
        p.write_bytes(animation(canvas, [(still, 0, 0, 1, 1, 0)]))
        with pytest.raises(cv2.error):
            cv2.imread(str(p))
        with pytest.raises(native.DecodeError):
            native.decode(p)
    assert assert_cv2_bits(tmp_path, animation((1, 1 << 20), [(still, 0, 0, 1, 1, 0)])
                           ).shape == (1 << 20, 1, 3)


# ---------------------------------------------------------------------------
# truncated and corrupt files
# ---------------------------------------------------------------------------

def _corpus():
    img = smooth(43, 58, 11)
    rgba = np.dstack([img, smooth(43, 58, 12, 1)])
    r = np.random.default_rng(5)
    pal = r.integers(0, 256, (11, 3), np.uint8)[r.integers(0, 11, (43, 58))]
    return {"lossy": pil_webp(img, quality=75), "lossless": pil_webp(img, lossless=True),
            "alpha": pil_webp(rgba, quality=75), "palette": pil_webp(pal, lossless=True),
            "cv2": cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes()}


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "palette", "cv2"])
def test_truncated_and_corrupt_files_as_cv2(tmp_path, kind):
    """Files cut short (as they are, and with their sizes rewritten to the
    cut, so only the bitstream ends early) are refused where cv2 refuses
    them; files with bytes overwritten give cv2's pixels or its refusal."""
    data = _corpus()[kind]
    r = np.random.default_rng(len(data))
    refused = 0
    for n in sorted(set(r.integers(0, len(data), 12).tolist())):
        refused += assert_cv2_bits(tmp_path, data[:n]) is None
        if n >= 24:
            cut = bytearray(data[:n])
            cut[4:8] = struct.pack("<I", n - 8)
            if cut[12:16] in (b"VP8 ", b"VP8L"):
                cut[16:20] = struct.pack("<I", n - 20)
            assert_cv2_bits(tmp_path, bytes(cut))
    assert refused
    for _ in range(40):
        bad = bytearray(data)
        for i in r.integers(20, len(bad), r.integers(1, 4)):
            bad[i] = r.integers(0, 256)
        assert_cv2_bits(tmp_path, bytes(bad))


def test_corrupt_alph_refuses_the_file_as_cv2(tmp_path):
    """cv2's colour read drops alpha, yet libwebp decodes ALPH and refuses
    a file whose ALPH is broken, with or without the VP8X alpha flag; so
    does the port."""
    rgba = np.dstack([smooth(30, 20, 1), smooth(30, 20, 2, 1)])
    ch = dict(chunks_of(pil_webp(rgba, quality=70)))
    raw_plane = bytes([0]) + bytes(smooth(30, 20, 3, 1).ravel())
    ll = pil_webp(np.dstack([smooth(30, 20, 1), smooth(30, 20, 2, 1)]), lossless=True)
    vp8l_alpha = bytes([1]) + dict(chunks_of(ll))[b"VP8L"][5:]  # a VP8L stream, headerless
    for flags in (0x10, 0):
        for alph, refused in ((ch[b"ALPH"], False), (raw_plane, False), (raw_plane[:300], True),
                              (bytes([ch[b"ALPH"][0] | 3]) + ch[b"ALPH"][1:], True),
                              (bytes([ch[b"ALPH"][0] | 0x40]) + ch[b"ALPH"][1:], True),
                              (b"", True), (vp8l_alpha[:40], True), (b"\x01" + b"\xff" * 50, True)):
            data = riff([vp8x(20, 30, flags), chunk(b"ALPH", alph), chunk(b"VP8 ", ch[b"VP8 "])])
            want = assert_cv2_bits(tmp_path, data)
            assert (want is None) == refused


def test_short_and_foreign_riff_files_are_refused(tmp_path):
    data = pil_webp(smooth(9, 9, 0), lossless=True)
    for bad in (data[:31], b"RIFF" + data[4:8] + b"WAVE" + data[12:],
                data[:12] + b"VP8Z" + data[16:], data[:4] + struct.pack("<I", 4) + data[8:]):
        assert assert_cv2_bits(tmp_path, bad) is None


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

def vp8_frame_header(payload: bytes) -> dict:
    """The segment, loop-filter and partition fields of a VP8 key frame's
    first partition (RFC 6386 section 9), read with the RFC's boolean
    decoder written out here."""
    tag = payload[0] | payload[1] << 8 | payload[2] << 16
    data = payload[10:10 + (tag >> 5)]
    st = {"value": int.from_bytes(data[:2], "big"), "range": 255, "count": 0, "pos": 2}

    def bit(prob=128):
        split = 1 + (((st["range"] - 1) * prob) >> 8)
        if st["value"] >= split << 8:
            b, st["range"], st["value"] = 1, st["range"] - split, st["value"] - (split << 8)
        else:
            b, st["range"] = 0, split
        while st["range"] < 128:
            st["value"], st["range"], st["count"] = st["value"] << 1, st["range"] << 1, \
                st["count"] + 1
            if st["count"] == 8:
                st["count"] = 0
                st["value"] |= data[st["pos"]] if st["pos"] < len(data) else 0
                st["pos"] += 1
        return b

    def lit(n):
        return sum(bit() << (n - 1 - k) for k in range(n))

    bit(), bit()
    segments, update_map = bit(), 0
    if segments:
        update_map = bit()
        if bit():
            bit()
            for n in (7, 7, 7, 7, 6, 6, 6, 6):
                if bit():
                    lit(n), bit()
        if update_map:
            for _ in range(3):
                if bit():
                    lit(8)
    simple, level, sharpness = bit(), lit(6), lit(3)
    if bit() and bit():
        for _ in range(8):
            if bit():
                lit(6), bit()
    return {"segments": segments, "simple": simple, "level": level, "sharpness": sharpness,
            "partitions": 1 << lit(2)}


FIXTURE_FEATURES = {
    "simple_filter": {"simple": 1}, "sharp3": {"sharpness": 3, "simple": 0},
    "sharp7": {"sharpness": 7, "simple": 0}, "parts2": {"partitions": 2},
    "parts4": {"partitions": 4}, "parts8": {"partitions": 8}, "seg1": {"segments": 0},
    "seg4": {"segments": 1}, "alpha_filtered": {}, "scene_lossy": {}, "scene_lossless": {}}


@pytest.mark.parametrize("name", sorted(FIXTURE_FEATURES))
def test_fixtures_match_their_twins_and_cv2(name):
    """Each fixture decodes to cv2's bits, which are its PNG twin's or, for
    the two full-detail 1080p scenes, those `digests.json` records."""
    path = FIXTURES / f"{name}.webp"
    data = path.read_bytes()
    twin = cv2.imread(str(path))
    if name.startswith("scene_"):
        assert json.loads((FIXTURES / "digests.json").read_text())[name] == digest(twin)
    else:
        np.testing.assert_array_equal(native.decode(path.with_suffix(".png")), twin)
    np.testing.assert_array_equal(native.decode(path), twin)
    np.testing.assert_array_equal(native.decode_mem(data), twin)
    ch = dict(chunks_of(data))
    if name == "scene_lossless":  # lossless: the picture itself
        assert b"VP8L" in ch
        np.testing.assert_array_equal(twin, synthetic_scene(SCENE, 1920, seed=7)[:1080])
        return
    fields = vp8_frame_header(ch[b"VP8 "])
    assert fields["level"] > 0 and fields.items() >= FIXTURE_FEATURES[name].items(), fields
    if name == "alpha_filtered":  # VP8L-compressed, a prediction filter
        assert ch[b"ALPH"][0] & 3 == 1 and (ch[b"ALPH"][0] >> 2) & 3 != 0
    if name == "scene_lossy":
        assert twin.shape == (1080, 1920, 3)


def test_fixture_seg4_has_four_segment_quantisers():
    """The 4-segment fixture's macroblocks fall in more than one segment:
    its decode differs from the 1-segment one of the same picture."""
    a, b = (native.decode(FIXTURES / f"seg{k}.webp") for k in (1, 4))
    assert a.shape == b.shape and (a != b).any()


# ---------------------------------------------------------------------------
# the data pipeline against the JAX package's
# ---------------------------------------------------------------------------

WEBP_SIZES = [(48, 64), (64, 64), (37, 53), (64, 40), (120, 70)]


def write_webp_dataset(root: Path, sizes, lossless_every=2):
    """images/train/im<i>.webp (lossy and lossless in turn, one with an
    EXIF orientation) and their labels; returns the image directory."""
    img_dir, lab_dir = root / "images" / "train", root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        rgb = scene(h, w, i)[..., ::-1].copy()
        data = pil_webp(rgb, lossless=True) if i % lossless_every else pil_webp(rgb, quality=85)
        if i == 2:
            data = riff([vp8x(w, h, 0x08), *image_chunks(data), chunk(b"EXIF", exif(6))])
        (img_dir / f"im{i}.webp").write_bytes(data)
        (lab_dir / f"im{i}.txt").write_text("\n".join(label_rows(1 + i % 3, i)) + "\n")
    return img_dir


def test_load_batch_declines_webp_as_jax_native(tmp_path):
    """`load_batch` declines WebP as the JAX native loader does (its caller
    redoes them through the item path, cv2's resize): the same canvases,
    sizes and statuses."""
    if not jax_native.available():
        pytest.skip("the JAX package's native loader did not build")
    img_dir = write_webp_dataset(tmp_path, WEBP_SIZES)
    cv2.imwrite(str(img_dir / "z.png"), scene(30, 40, 9))
    paths = sorted(str(p) for p in img_dir.iterdir())
    for size in (64, 120):
        got, want = native.load_batch(paths, size, 114, 2), jax_native.load_batch(paths, size, 114, 2)
        for a, b, what in zip(got, want, ("imgs", "hw", "status")):
            np.testing.assert_array_equal(a, b, err_msg=what)
        assert list(got[2][:-1]) == [native.ERR_FORMAT] * len(WEBP_SIZES) and got[2][-1] == 0


@pytest.mark.parametrize("imgsz", [64, 120])
def test_dataset_and_batches_equal_jax(tmp_path, imgsz):
    """Items, and device-augment train batches through the native ingest (the
    WebPs redone through the item path on both sides), at 64 px (the long
    side resized) and at 120 px (the largest image at its own size)."""
    img_dir = write_webp_dataset(tmp_path, WEBP_SIZES)
    ours, theirs = YOLODataset(str(img_dir)), JaxYOLODataset(str(img_dir), imgsz=imgsz)
    assert ours.im_files == theirs.im_files
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=0, atol=1e-4)
    assert ours[2]["img"].shape[:2] == (53, 37)  # EXIF 6 turned
    ol = DataLoader(ours, 2, imgsz, seed=4, train=True, device_augment=True, hyp=TRAIN_DEFAULTS,
                    workers=2)
    tl = JaxDataLoader(theirs, 2, imgsz, train=True, seed=4, workers=2, device_augment=True)
    assert ol.native_eligible() and theirs is tl.dataset
    for g, w in zip(list(ol), list(tl)):
        for k in ("img", "img_hw", "gt_labels", "mask_gt"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_allclose(g["gt_bboxes"], w["gt_bboxes"], rtol=0, atol=1e-4)


def test_sources_and_classify_equal_jax(tmp_path):
    """`LoadImagesAndVideos` (the predictor's and the tracker's source) over
    a WebP directory, an unreadable WebP skipped as JAX skips it, and the
    classify dataset's images against JAX's `cv2.imread` + `cv2.resize`."""
    img_dir = write_webp_dataset(tmp_path, WEBP_SIZES)
    (img_dir / "zz.webp").write_bytes(b"RIFF\x10\0\0\0WEBPVP8 " + b"\0" * 30)
    ours, theirs = LoadImagesAndVideos(img_dir), JaxLoadImages(img_dir)
    assert ours.files == theirs.files
    got, want = list(ours), list(theirs)
    assert [g["path"] for g in got] == [w["path"] for w in want] and len(got) == len(WEBP_SIZES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["img"], w["img"])
    root = tmp_path / "cls"
    for c in range(2):
        (root / f"c{c}").mkdir(parents=True)
        for k, (h, w) in enumerate([(32, 32), (64, 64), (40, 56)]):
            rgb = smooth(h, w, 10 * c + k)
            data = pil_webp(rgb, lossless=True) if k % 2 else pil_webp(rgb, quality=80)
            (root / f"c{c}" / f"{k}.webp").write_bytes(data)
    ours, theirs = CL.ClassificationDataset(str(root), imgsz=32), \
        JCL.ClassificationDataset(str(root), imgsz=32)
    assert [(str(f), c) for f, c in ours.items] == [(str(f), c) for f, c in theirs.items]
    for (f, _), g in zip(theirs.items, ours.load(list(range(len(ours))))):
        w = theirs._load(f)
        if cv2.imread(f).shape[0] in (32, 64):  # ratio 1 and 2x down: cv2's bits
            np.testing.assert_array_equal(g, w)
        d = np.abs(g.astype(np.int32) - w)
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, f


# ---------------------------------------------------------------------------
# no libwebp
# ---------------------------------------------------------------------------

def test_no_libwebp_in_the_port():
    """No source of `native/src` includes a `webp/` header, the decoder's
    build names no WebP library, and the built library needs none."""
    import re
    import subprocess
    src = Path(native.__file__).parent / "src"
    for f in sorted(src.glob("*.[ch]*")):
        assert not re.search(r'#\s*include\s*[<"]webp/', f.read_text()), f.name
    assert all(f.parent == src for f in build.HOST_LOADER_SOURCES)
    assert not any("webp" in a.lower() and a.startswith(("-l", "-L")) or a.endswith(".a")
                   for a in build.host_command())
    native.get_lib()
    out = subprocess.run(["ldd", str(build.library_path(build.HOST_LOADER))],
                         capture_output=True, text=True)
    assert out.returncode == 0 and "webp" not in out.stdout.lower(), out.stdout
