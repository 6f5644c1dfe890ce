"""The port's image decoder, inference sources and predictor over files
against cv2 and the JAX package, on the CPU.

Here the decoder is built without nvJPEG (no CUDA device), so JPEG files
are held on the card (`chip_smoke.py` phase 15, against the committed
fixtures' PNG twins); on the CPU a JPEG raises, naming what it needs.
What the JPEG path does on the host is held here: libjpeg's own Y, Cb and
Cr planes, put through the port's chroma upsampling and YCbCr -> RGB
conversion (`ycc_to_rgb` in `native/src/host_loader.cpp`), give
`cv2.imread`'s bits, so on the card only nvJPEG's IDCT differs.

Tolerances, each with its reason:

* PNG decode against `cv2.imread`, `load_batch` against JAX's native
  `load_batch`, the planes' conversion against cv2: exact (lossless, the
  same integer arithmetic);
* the predictor over a directory: detections and classes exact, boxes
  1e-3 px, scores 1e-5, the predictor's limits (`tests/test_torch_predict.py`:
  float32 sums in another order).
"""
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from mgdt_yolo_tpu import native as jax_native
from mgdt_yolo_tpu.data.loaders import LoadImagesAndVideos as JaxLoadImages
from mgdt_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.data.loaders import LoadImagesAndVideos, load_inference_source
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from test_torch_dataset import scene
from test_torch_predict import ATOL_BOX, CONF, IMGSZ, _same_results, flagship  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = Path(native.__file__).parent / "fixtures"


# ---------------------------------------------------------------------------
# PNG files of every kind, against cv2
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def adam7_png(img: np.ndarray) -> bytes:
    """An interlaced (Adam7) 8-bit RGB PNG of a BGR image, each pass's rows
    Sub-filtered (cv2 and PIL write no interlaced files)."""
    h, w = img.shape[:2]
    rgb = img[..., ::-1]
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = rgb[y0::dy, x0::dx].astype(np.int16)
        if not sub.size:
            continue
        for row in sub.reshape(sub.shape[0], -1):
            filt = row.copy()
            filt[3:] = (row[3:] - row[:-3]) % 256
            raw += b"\x01" + filt.astype(np.uint8).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw)) + \
        _chunk(b"IEND", b"")


def _write_png(path: Path, kind: str):
    from PIL import Image
    rng = np.random.default_rng(len(kind))
    img = scene(37, 53, len(kind))
    if kind == "rgb":
        cv2.imwrite(str(path), img)
    elif kind == "grey":
        cv2.imwrite(str(path), img[..., 1])
    elif kind == "rgb16":
        cv2.imwrite(str(path), rng.integers(0, 65536, (21, 34, 3), dtype=np.uint16))
    elif kind == "grey16":
        cv2.imwrite(str(path), rng.integers(0, 65536, (21, 34), dtype=np.uint16))
    elif kind == "rgba":
        cv2.imwrite(str(path), np.dstack([img, rng.integers(0, 256, img.shape[:2], np.uint8)]))
    elif kind == "grey_alpha":
        Image.fromarray(np.dstack([img[..., 0], img[..., 1]]), "LA").save(path)
    elif kind == "palette":
        Image.fromarray(img[..., ::-1]).quantize(colors=40).save(path)
    elif kind == "palette4":
        Image.fromarray(img[..., ::-1]).quantize(colors=12).save(path, bits=4)
    elif kind == "bilevel":
        Image.fromarray(img[..., 0] > 120).save(path)
    elif kind == "interlaced":
        path.write_bytes(adam7_png(img))
    elif kind == "one_pixel":
        path.write_bytes(adam7_png(img[:1, :1]))


PNG_KINDS = ["rgb", "grey", "rgb16", "grey16", "rgba", "grey_alpha", "palette", "palette4",
             "bilevel", "interlaced", "one_pixel"]


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_png_decode_matches_cv2(tmp_path, kind):
    p = tmp_path / f"{kind}.png"
    _write_png(p, kind)
    got = native.decode(p)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, cv2.imread(str(p)))


def test_decode_errors(tmp_path):
    """A missing or unreadable file raises `DecodeError` with its status; a
    format the port does not decode raises `UnsupportedFormat` naming it;
    on a machine without nvJPEG a JPEG raises, naming what it needs."""
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n nonsense")
    for path, status in ((tmp_path / "nope.png", native.ERR_OPEN), (bad, native.ERR_DECODE)):
        with pytest.raises(native.DecodeError) as err:
            native.decode(path)
        assert err.value.status == status
    for suffix in ("bmp", "webp", "tiff"):
        with pytest.raises(native.UnsupportedFormat, match=suffix):
            native.decode(tmp_path / f"x.{suffix}")
    if not native.has_jpeg():
        with pytest.raises(native.DecodeError, match="CUDA device"):
            native.decode(FIXTURES / "color420.jpg")
    out = native.decode_batch([tmp_path / "nope.png", bad])
    assert all(isinstance(o, native.DecodeError) for o in out)


def test_fixtures_hold_cv2s_decode():
    """The committed JPEG fixtures (one grey, one progressive, two
    EXIF-rotated) and their PNG twins: each twin is `cv2.imread`'s decode of
    its JPEG, and the port reads each twin as cv2 does; all under 1 MB."""
    jpgs = sorted(FIXTURES.glob("*.jpg"))
    assert len(jpgs) == 6 and sum(f.stat().st_size for f in FIXTURES.iterdir()) < 1 << 20
    for j in jpgs:
        twin = j.with_suffix(".png")
        want = cv2.imread(str(j))
        np.testing.assert_array_equal(cv2.imread(str(twin)), want, err_msg=j.name)
        np.testing.assert_array_equal(native.decode(twin), want, err_msg=j.name)
    assert cv2.imread(str(FIXTURES / "exif6.jpg")).shape[:2] == (120, 64)


# ---------------------------------------------------------------------------
# the JPEG path's host half: libjpeg's planes through the port's conversion
# ---------------------------------------------------------------------------

HARNESS = r'''
#include "host_loader.cpp"
#include <jpeglib.h>
// libjpeg's raw Y, Cb, Cr planes of a JPEG put through ycc_to_rgb, as BGR
extern "C" int planes_to_bgr(const char* path, unsigned char* out, int cap, int* ow, int* oh) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct ci;
  jpeg_error_mgr jerr;
  ci.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&ci);
  jpeg_stdio_src(&ci, f);
  jpeg_read_header(&ci, TRUE);
  ci.raw_data_out = TRUE;
  ci.out_color_space = ci.jpeg_color_space;
  jpeg_start_decompress(&ci);
  const int nc = ci.num_components, w = ci.image_width, h = ci.image_height;
  std::vector<std::vector<uint8_t>> planes(nc);
  std::vector<int> pitch(nc);
  for (int c = 0; c < nc; c++) {
    pitch[c] = ci.comp_info[c].width_in_blocks * DCTSIZE;
    planes[c].resize((size_t)pitch[c] * (ci.comp_info[c].height_in_blocks * DCTSIZE + 64));
  }
  std::vector<std::vector<JSAMPROW>> rows(nc);
  for (int done = 0; ci.output_scanline < ci.output_height; done++) {
    JSAMPARRAY arrs[4];
    for (int c = 0; c < nc; c++) {
      const int n = ci.comp_info[c].v_samp_factor * DCTSIZE;
      rows[c].resize(n);
      for (int r = 0; r < n; r++)
        rows[c][r] = planes[c].data() + (size_t)(done * n + r) * pitch[c];
      arrs[c] = rows[c].data();
    }
    jpeg_read_raw_data(&ci, arrs, ci.max_v_samp_factor * DCTSIZE);
  }
  std::vector<uint8_t> rgb((size_t)w * h * 3);
  if (nc == 3) {
    const int cw = ci.comp_info[1].downsampled_width, ch = ci.comp_info[1].downsampled_height;
    ycc_to_rgb(planes[0].data(), pitch[0], planes[1].data(), planes[2].data(), pitch[1], cw,
               ch, ci.max_h_samp_factor / ci.comp_info[1].h_samp_factor,
               ci.max_v_samp_factor / ci.comp_info[1].v_samp_factor, 3, w, h, rgb.data());
  } else {
    ycc_to_rgb(planes[0].data(), pitch[0], nullptr, nullptr, 0, 0, 0, 1, 1, 1, w, h, rgb.data());
  }
  jpeg_abort_decompress(&ci);
  jpeg_destroy_decompress(&ci);
  fclose(f);
  *ow = w;
  *oh = h;
  if ((size_t)cap < rgb.size()) return -2;
  for (size_t i = 0; i < (size_t)w * h; i++)
    for (int k = 0; k < 3; k++) out[i * 3 + k] = rgb[i * 3 + 2 - k];
  return 0;
}
'''


@pytest.fixture(scope="module")
def planes_to_bgr(tmp_path_factory):
    import ctypes
    d = tmp_path_factory.mktemp("harness")
    (d / "harness.cpp").write_text(HARNESS)
    src = Path(native.__file__).parent / "src"
    so = d / "harness.so"
    proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{src}",
                           str(d / "harness.cpp"), "-o", str(so), "-ljpeg", "-lz",
                           "-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))

    def run(path):
        buf = np.zeros(256 * 256 * 3, np.uint8)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = lib.planes_to_bgr(str(path).encode(), buf.ctypes.data_as(ctypes.c_void_p),
                               buf.size, ctypes.byref(w), ctypes.byref(h))
        assert rc == 0
        return buf[:w.value * h.value * 3].reshape(h.value, w.value, 3)
    return run


SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_chroma_upsampling_and_conversion_match_cv2(planes_to_bgr, tmp_path, sampling):
    """libjpeg's planes through the port's conversion give cv2's bits, for
    every chroma subsampling, baseline and progressive, at sizes down to a
    pixel (where libjpeg takes its plain upsampling), and for a grey JPEG."""
    rng = np.random.default_rng(int(sampling))
    p = tmp_path / "x.jpg"
    for k in range(12):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        img = rng.integers(0, 256, (h, w, 3), np.uint8) if k % 2 else scene(h, w, k)
        cv2.imwrite(str(p), img, [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(50, 100)),
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                  cv2.IMWRITE_JPEG_PROGRESSIVE, int(k % 3 == 0)])
        np.testing.assert_array_equal(planes_to_bgr(p), cv2.imread(str(p)), err_msg=(h, w))
    cv2.imwrite(str(p), scene(31, 45, 1)[..., 0])
    np.testing.assert_array_equal(planes_to_bgr(p), cv2.imread(str(p)))


# ---------------------------------------------------------------------------
# load_batch against JAX's native loader
# ---------------------------------------------------------------------------

def test_load_batch_matches_jax_native(tmp_path):
    """The canvases, pasted sizes and statuses of JAX's native `load_batch`
    on PNGs of every shape class (down- and up-sized, exact, grey), a
    missing file and a non-image: the same bits."""
    if not jax_native.available():
        pytest.skip("the JAX package's native loader did not build")
    paths = []
    for i, (h, w) in enumerate([(48, 64), (120, 70), (64, 64), (20, 31), (200, 90)]):
        p = tmp_path / f"im{i}.png"
        img = scene(h, w, i)
        cv2.imwrite(str(p), img[..., 0] if i == 3 else img)
        paths.append(str(p))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    paths += [str(tmp_path / "nope.png"), str(tmp_path / "bad.png")]
    got = native.load_batch(paths, 64, 114, 3)
    want = jax_native.load_batch(paths, 64, 114, 3)
    for a, b, what in zip(got, want, ("imgs", "hw", "status")):
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert list(got[2][-2:]) == [native.ERR_OPEN, native.ERR_FORMAT]


# ---------------------------------------------------------------------------
# inference sources and the predictor over a directory
# ---------------------------------------------------------------------------

def _image_dir(root: Path, sizes, seed=0) -> Path:
    d = root / "frames"
    (d / "sub").mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(d / ("sub" if i % 3 == 2 else ".") / f"f{i}.png"), scene(h, w, seed + i))
    (d / "notes.txt").write_text("not an image")
    return d


def test_sources_list_as_jax(tmp_path, caplog):
    """A directory (any depth), a glob and a file list the files the JAX
    loader lists; an unreadable image is skipped with a warning, as JAX
    skips it; videos, streams, screenshots and undecoded formats raise."""
    d = _image_dir(tmp_path, [(40, 50), (60, 30), (35, 35), (20, 20)])
    (d / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    for src in (d, str(d / "*.png"), str(d / "**" / "*.png"), d / "f0.png"):
        ours, theirs = LoadImagesAndVideos(src), JaxLoadImages(src)
        assert ours.files == theirs.files
        got, want = list(ours), list(theirs)
        assert [g["path"] for g in got] == [w["path"] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["img"], w["img"])
    assert any("unreadable image" in r.message for r in caplog.records)
    arrays = load_inference_source([scene(10, 12, 0), scene(8, 9, 1)])
    assert [it["path"] for it in arrays] == ["array0.jpg", "array1.jpg"]
    (tmp_path / "clip.mp4").write_bytes(b"")
    (tmp_path / "x.webp").write_bytes(b"")
    for src, word in ((tmp_path / "clip.mp4", "video"), ("0", "stream"),
                      ("rtsp://cam/1", "stream"), ("screen 0", "screenshot"),
                      (tmp_path / "x.webp", "webp")):
        with pytest.raises(NotImplementedError, match=word):
            load_inference_source(src)
    with pytest.raises(FileNotFoundError):
        load_inference_source(tmp_path / "missing")


EXACT_DIR_SIZES = [(96, 64), (192, 128), (288, 288), (48, 96), (96, 72)]


def test_predictor_on_a_directory_matches_jax(flagship, tmp_path):  # noqa: F811
    """Both predictors over the same directory of PNG frames (sizes whose
    letterbox is exact) at batch 2: the same paths in the same order, the
    same detections within the predictor's limits, and `save_txt` files of the same
    names holding the same rows."""
    pm, jm = flagship
    d = _image_dir(tmp_path, EXACT_DIR_SIZES, seed=20)
    kw = {"imgsz": IMGSZ, "conf": CONF, "save_txt": True, "project": str(tmp_path)}
    ours = DetectionPredictor(overrides={**kw, "device": "cpu", "name": "port"}).setup_model(pm)
    theirs = JaxPredictor(overrides={**kw, "save": False, "name": "jax"})
    theirs.setup_model(jm, jm.variables)
    got, want = ours(d, batch=2), theirs(str(d), batch=2)
    assert [r.path for r in got] == [r.path for r in want] == LoadImagesAndVideos(d).files
    assert _same_results(got, want) > 0
    assert all(r.speed["preprocess"] > 0 for r in got)
    files = sorted(p.name for p in (tmp_path / "port" / "labels").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax" / "labels").iterdir())
    assert set(files) <= {f"{Path(r.path).stem}.txt" for r in got} and files
    for name in files:
        a, b = (np.loadtxt(tmp_path / who / "labels" / name, ndmin=2) for who in ("port", "jax"))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=ATOL_BOX / 48 + 1e-6)
    one = ours(d / "f0.png")
    assert len(one) == 1 and one[0].path == str(d / "f0.png")
    shutil.rmtree(tmp_path / "port")
