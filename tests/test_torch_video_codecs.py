"""MPEG-4 Part 2 and VP8 videos through the port's own host decoders
(`native/src/host_mpeg4.cpp`, `host_vp8.h`, `host_yuv.h`), held to cv2's
reading, which is the JAX package's (`cv2.VideoCapture`, ffmpeg), on the CPU.

* Frames: every frame of streams cv2's writer makes here (a textured pan
  with a saturated disc, 30 frames: three GOPs) is cv2's bit for bit, with
  cv2's frame count and fps: `mp4v` in MP4, MKV and AVI under `XVID`,
  `DIVX` and `FMP4`, and VP8 in WebM and MKV, at 64x48 and at 100x70 (not
  a multiple of 16); the same stream with its user data naming Xvid, which
  makes ffmpeg (and the port) use Xvid's IDCT; the committed 4MV stream
  with video packets and the committed 1080p clips (`codecs.json`); a VP8
  stream whose size changes at a key frame.
* `LoadImagesAndVideos` items equal JAX's at `vid_stride` 1, 2 and 3, and
  a reader read backwards starts again from the key frame before.
* The predictor over an `mp4v` MP4 and a VP8 WebM equals JAX's (counts and
  classes exact, boxes within 1e-3 px, scores within 1e-5), and the video
  JAX's `save=True` writes is read as cv2 reads it; `YOLO.track` over a
  folder holding one of each equals JAX's (IDs and classes exact, boxes
  within 1e-3 px).
* Every coding tool outside the Simple Profile and every codec the port
  does not decode raises `UnsupportedVideo`, naming it and why.
* The YUV-to-BGR rows by SSSE3 and by tables agree for every (Y, U, V).
"""
import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

import mgdt_yolo_tpu.engine.model as jax_model
from mgdt_yolo_tpu.data.loaders import LoadImagesAndVideos as JaxLoader
from mgdt_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.data.loaders import LoadImagesAndVideos
from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
from mgdt_yolo_tpu_torch.engine import model as port_model
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.native import video
from mgdt_yolo_tpu_torch.native.video import VideoReader
from test_torch_predict import CONF, IMGSZ, NPZ, _same_results, flagship  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_tracker import _same_track_results
from torch_video_fixtures import VP8_VARIANTS, avi_of, webm_of

FIX = Path(native.__file__).parent / "fixtures" / "video"
SIZES = [(64, 48), (100, 70)]
MPEG4 = [("mp4", "mp4v"), ("mkv", "mp4v"), ("avi", "XVID"), ("avi", "DIVX"), ("avi", "FMP4")]
VP8 = [("webm", "VP80"), ("mkv", "VP80")]
KEYS = ("path", "frame_idx", "is_video", "fps")


def pan(size, n, seed=0):
    """A textured scene panning 3 px a frame (and half a pixel down every
    other), a saturated disc on it: BGR frames of `size` (w, h)."""
    w, h = size
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 4 + 8, (w + 3 * n) // 4 + 8, 3), np.uint8)
    big = cv2.resize(small, (small.shape[1] * 4, small.shape[0] * 4),
                     interpolation=cv2.INTER_CUBIC)
    cv2.circle(big, (w // 2, h // 2), max(2, min(w, h) // 4), (0, 255, 255), -1)
    return [np.ascontiguousarray(big[i // 2:i // 2 + h, 3 * i:3 * i + w]) for i in range(n)]


def write(path: Path, fourcc: str, frames, fps: float = 25) -> Path:
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened(), path
    for f in frames:
        vw.write(f)
    vw.release()
    return path


def cv2_frames(path):
    cap, out = cv2.VideoCapture(str(path)), []
    while True:
        ok, img = cap.read()
        if not ok:
            return out, cap.get(cv2.CAP_PROP_FPS)
        out.append(img)


def assert_reads_as_cv2(path) -> VideoReader:
    want, fps = cv2_frames(path)
    r = VideoReader(path)
    assert (r.frames, r.fps) == (len(want), fps) and want
    for i, (g, w) in enumerate(zip(r.read(range(r.frames)), want)):
        assert not isinstance(g, native.DecodeError), g
        np.testing.assert_array_equal(g, w, err_msg=f"{path.name} frame {i}")
    return r


def sha256(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def samples(path):
    """A video's samples (bytes) as the port's demuxer finds them."""
    import ctypes
    r = VideoReader(path)
    off, size = np.zeros(2 * r.frames + 16, np.int64), np.zeros(2 * r.frames + 16, np.int64)
    video._lib().mgdt_video_index.argtypes = [ctypes.c_void_p] * 3
    video._lib().mgdt_video_index(r._h, off.ctypes.data, size.ctypes.data)
    data = Path(path).read_bytes()
    return [data[o:o + s] for o, s in zip(off, size) if s]


# ---------------------------------------------------------------------------
# frames against cv2's reading
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ext,fourcc", MPEG4, ids=[f"{e}-{f}" for e, f in MPEG4])
def test_mpeg4_part2_frames_equal_cv2(tmp_path, ext, fourcc, size):
    r = assert_reads_as_cv2(write(tmp_path / f"a.{ext}", fourcc, pan(size, 30)))
    assert r.size == size


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ext,fourcc", VP8, ids=[e for e, _ in VP8])
def test_vp8_frames_equal_cv2(tmp_path, ext, fourcc, size):
    r = assert_reads_as_cv2(write(tmp_path / f"a.{ext}", fourcc, pan(size, 30, seed=1)))
    assert r.size == size


def test_xvid_user_data_picks_xvids_idct(tmp_path):
    """A stream whose user data names Xvid is read with Xvid's IDCT (as
    ffmpeg reads it): cv2's reading changes, and the port's follows it."""
    import re
    p = write(tmp_path / "a.avi", "XVID", pan((100, 70), 30))
    data = p.read_bytes()
    # each I-VOP's user data (to the next start code), its length kept
    xvid = tmp_path / "x.avi"
    xvid.write_bytes(re.sub(rb"(?<=\x00\x00\x01\xb2)Lavc[^\x00]*",
                            lambda m: b"XviD0064".ljust(len(m.group())), data))
    assert xvid.read_bytes().count(b"XviD0064") >= 2 and b"Lavc6" in data
    lavc, _ = cv2_frames(p)
    assert_reads_as_cv2(xvid)
    assert sum((a != b).any() for a, b in zip(lavc, cv2_frames(xvid)[0])) >= 10


def test_committed_4mv_stream_equals_cv2():
    """The libavcodec stream with four vectors in some macroblocks and video
    packets (`tests/torch_video_fixtures.py`): cv2's frames by digest, and
    cv2's live reading."""
    fx = json.loads((FIX / "codecs.json").read_text())["mpeg4_4mv.avi"]
    assert "+mv4" in fx["options"]["flags"] and int(fx["options"]["ps"]) > 0
    r = assert_reads_as_cv2(FIX / "mpeg4_4mv.avi")
    assert [sha256(f) for f in r.read(range(r.frames))] == fx["sha256"]


@pytest.mark.parametrize("name", sorted(VP8_VARIANTS))
def test_committed_vp8_variants_equal_cv2(name):
    """libvpx streams cv2's writer does not make (`tests/torch_video_fixtures.py`):
    version 1's bilinear filters, simple loop filter and sharpness, version
    3's full-sample chroma, error resilience's segment maps and
    probabilities that are not kept; cv2's frames by digest and live."""
    fx = json.loads((FIX / "codecs.json").read_text())[name]
    assert fx["options"] == VP8_VARIANTS[name]
    r = assert_reads_as_cv2(FIX / name)
    assert [sha256(f) for f in r.read(range(r.frames))] == fx["sha256"]


def test_a_frame_not_shown_is_decoded_and_not_counted(tmp_path):
    """A VP8 frame marked not shown (show_frame 0) and an MPEG-4 VOP marked
    not coded: cv2 counts neither, the frames after them are cv2's."""
    vp8 = samples(write(tmp_path / "a.webm", "VP80", pan((64, 48), 12, seed=6)))
    vp8[5] = bytes([vp8[5][0] & ~0x10]) + vp8[5][1:]
    p = tmp_path / "b.webm"
    p.write_bytes(webm_of([(d, not (d[0] & 1)) for d in vp8], (64, 48)))
    r = assert_reads_as_cv2(p)
    assert r.frames == 11
    m4 = samples(write(tmp_path / "a.avi", "XVID", pan((64, 48), 12, seed=6)))
    d = bytearray(m4[5])  # a P-VOP: type, modulo_time_base, marker, 5-bit time, marker, vop_coded
    k = d.index(b"\0\0\1\xb6") + 4
    bits = "".join(f"{x:08b}" for x in d[k:k + 4])
    at = bits.index("0", 2) + 1 + 1 + 5 + 1
    assert bits[:2] == "01" and bits[at] == "1"
    d[k + at // 8] &= ~(0x80 >> (at % 8))
    q = tmp_path / "b.avi"
    q.write_bytes(avi_of([(x, i == 0) for i, x in enumerate(m4[:5] + [bytes(d)] + m4[6:])],
                         (64, 48), 25, b"XVID"))
    r = assert_reads_as_cv2(q)
    assert r.frames == 11


@pytest.mark.parametrize("name", ["pan1080.mp4", "pan1080.webm"])
def test_committed_1080p_clips_equal_cv2(name):
    """The clips `chip_smoke.py` phase 26 holds on the card's host: cv2's
    fps, size and digests, which the port gives here too."""
    fx = json.loads((FIX / "codecs.json").read_text())[name]
    r = VideoReader(FIX / name)
    assert (r.fps, list(r.size), r.frames) == (fx["fps"], fx["size"], len(fx["sha256"]))
    assert [sha256(f) for f in r.read(range(r.frames))] == fx["sha256"]
    assert [sha256(f) for f in cv2_frames(FIX / name)[0]] == fx["sha256"]


def test_vp8_size_change_at_a_key_frame(tmp_path):
    """Two cv2 VP8 streams of other sizes, one after the other in a WebM: the
    second's key frame changes the size. The port gives each frame at its
    own size, the second stream's as cv2 reads that stream alone; cv2 scales
    the later frames to the first size with swscale's bicubic filter
    (`ROADMAP.md` queue 3, known differences)."""
    one = write(tmp_path / "a.webm", "VP80", pan((64, 48), 8))
    two = write(tmp_path / "b.webm", "VP80", pan((100, 70), 8, seed=2))
    frames = [(d, not (d[0] & 1)) for d in samples(one) + samples(two)]
    p = tmp_path / "c.webm"
    p.write_bytes(webm_of(frames, (64, 48)))
    got = VideoReader(p).read(range(16))
    want = cv2_frames(one)[0] + cv2_frames(two)[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    theirs, _ = cv2_frames(p)
    assert len(theirs) == 16 and {t.shape for t in theirs} == {(48, 64, 3)}
    for g, t in zip(got[:8], theirs[:8]):
        np.testing.assert_array_equal(g, t)
    assert all(g.shape == (70, 100, 3) for g in got[8:])


def test_odd_height_is_decoded_as_cv2_and_converted_by_another_path():
    """An odd height (a 64x47 stream from libavcodec; cv2's writer makes
    even sizes): the decoded planes are cv2's, since both readers' BT.601
    luma stays within 4 levels of the Y plane cv2 gives unconverted; the
    BGR is not, since swscale converts an odd height through its scaler,
    not the unscaled arithmetic the port follows (measured: max 86 levels,
    3.9-4.4% of values equal; `ROADMAP.md` queue 3, known differences)."""
    p = FIX / "mpeg4_odd_height.avi"
    ours, (theirs, _) = VideoReader(p).read(range(6)), cv2_frames(p)
    cap, planes = cv2.VideoCapture(str(p), cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0]), []
    while (got := cap.read())[0]:
        planes.append(got[1])
    assert len(ours) == len(theirs) == len(planes) == 6

    def luma(bgr):
        b, g, r = (bgr[..., k].astype(np.float64) for k in range(3))
        return 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255

    for o, t, y in zip(ours, theirs, planes):
        assert o.shape == t.shape == (47, 64, 3) and y.shape == (47, 64)
        assert np.abs(luma(o) - y).max() < 4 and np.abs(luma(t) - y).max() < 4
        assert (o != t).mean() > 0.5


YUV_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "host_yuv.h"
using namespace mgdt_codec;
// every (Y, U, V): a row of 512 pixels (Y = x / 2) for each chroma pair,
// through the SSSE3 row and through the tables alone
int main() {
  const auto& t = yuv::tables();
  std::vector<uint8_t> py(512), a(512 * 3), b(512 * 3);
  std::vector<int16_t> cb(264), cg(264), cr(264);
  long bad = 0;
  for (int x = 0; x < 512; x++) py[x] = (uint8_t)(x >> 1);
  for (int u = 0; u < 256; u++)
    for (int v = 0; v < 256; v++) {
      for (int c = 0; c < 264; c++) {
        cb[c] = t.ub[u];
        cg[c] = (int16_t)(t.ug[u] + t.vg[v]);
        cr[c] = t.vr[v];
      }
      row_scalar(py.data(), cb.data(), cg.data(), cr.data(), 0, 512, a.data());
      const int x0 = row_ssse3(py.data(), cb.data(), cg.data(), cr.data(), 512, b.data());
      row_scalar(py.data(), cb.data(), cg.data(), cr.data(), x0, 512, b.data());
      bad += x0 != 512 || a != b;
    }
  printf("%ld\n", bad);
  return 0;
}
"""


def test_yuv_rows_by_ssse3_and_by_tables_agree(tmp_path):
    """The conversion's two row paths (16 pixels at a time where the CPU has
    SSSE3, tables elsewhere) give the same bits for every (Y, U, V)."""
    import platform
    import subprocess
    if platform.machine() not in ("x86_64", "AMD64") or "ssse3" not in \
            Path("/proc/cpuinfo").read_text():
        pytest.skip("the SSSE3 row runs on x86 CPUs with SSSE3 only")
    src = Path(native.__file__).parent / "src"
    (tmp_path / "h.cpp").write_text(YUV_HARNESS)
    exe = tmp_path / "h"
    subprocess.run(["g++", "-O2", "-std=c++17", f"-I{src}", str(tmp_path / "h.cpp"), "-o",
                    str(exe)], check=True, capture_output=True)
    assert subprocess.run([str(exe)], capture_output=True, text=True,
                          check=True).stdout.strip() == "0"


# ---------------------------------------------------------------------------
# the loader and the reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", (1, 2, 3))
@pytest.mark.parametrize("ext,fourcc", [("mp4", "mp4v"), ("webm", "VP80")])
def test_loader_items_equal_jax(tmp_path, ext, fourcc, stride):
    p = write(tmp_path / f"a.{ext}", fourcc, pan((100, 70), 26, seed=3))
    want = list(JaxLoader(str(p), stride))
    got = list(LoadImagesAndVideos(str(p), stride))
    assert len(got) == len(want) == 26 // stride
    for g, w in zip(got, want):
        assert {k: g[k] for k in KEYS} == {k: w[k] for k in KEYS}
        np.testing.assert_array_equal(g["img"], w["img"])


@pytest.mark.parametrize("ext,fourcc", [("avi", "XVID"), ("mkv", "VP80")])
def test_read_backwards_starts_at_the_key_frame_before(tmp_path, ext, fourcc):
    p = write(tmp_path / f"a.{ext}", fourcc, pan((64, 48), 30, seed=4))
    want, _ = cv2_frames(p)
    r = VideoReader(p)
    for order in ([20, 25], [3], [14, 15, 29], [0], [28], [13]):
        for i, img in zip(order, r.read(order)):
            np.testing.assert_array_equal(img, want[i], err_msg=f"{order} {i}")


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, v: int, n: int):
        self.bits += [(v >> (n - 1 - k)) & 1 for k in range(n)]

    def bytes(self) -> bytes:  # MPEG-4's stuffing: a 0, then 1s to the byte's end
        bits = self.bits + [0] + [1] * ((7 - len(self.bits)) % 8)
        return bytes(int("".join(map(str, bits[k:k + 8])), 2) for k in range(0, len(bits), 8))


def vol(w, h, interlaced=0, sprite=0, not8=0, mpeg_quant=0, qpel=0, partitioned=0):
    """A video object layer header with the tools given (verid 2 where the
    tool needs it)."""
    verid = 2 if qpel or sprite == 2 else 1
    b = BitWriter()
    b.put(0, 1), b.put(1, 8), b.put(1, 1), b.put(verid, 4), b.put(1, 3), b.put(1, 4)
    b.put(1, 1), b.put(1, 2), b.put(1, 1), b.put(0, 1)  # 4:2:0, low delay, no VBV
    b.put(0, 2), b.put(1, 1), b.put(25, 16), b.put(1, 1), b.put(0, 1)
    b.put(1, 1), b.put(w, 13), b.put(1, 1), b.put(h, 13), b.put(1, 1)
    b.put(interlaced, 1), b.put(1, 1), b.put(sprite, 1 if verid == 1 else 2)
    b.put(not8, 1), b.put(mpeg_quant, 1)
    if verid != 1:
        b.put(qpel, 1)
    b.put(1, 1), b.put(1, 1), b.put(partitioned, 1)
    if partitioned:
        b.put(0, 1)
    if verid != 1:
        b.put(0, 2)
    b.put(0, 1)
    return b"\0\0\1\0\0\0\1\x20" + b.bytes()


TOOLS = {"interlace": dict(interlaced=1), "GMC": dict(sprite=2), "sprites": dict(sprite=1),
         "quarter-pel": dict(qpel=1), "data partitioning": dict(partitioned=1),
         "MPEG quantisation": dict(mpeg_quant=1), "not-8-bit": dict(not8=1)}
CODECS = ["B-VOPs", "packed", "short_video_header", "V_VP9", "V_AV1", "H264", "hvc1",
          "MPEG-2"]


@pytest.mark.parametrize("case", [*TOOLS, *CODECS])
def test_tools_and_codecs_not_decoded_raise_naming_them(tmp_path, case):
    """Each tool outside the Simple Profile, and each codec the port does not
    decode, raises `UnsupportedVideo` naming it: at open where the headers
    say so, else at the sample that uses it. H.264 and HEVC are blocked (no
    encoder makes a stream to hold a decoder to), the rest not yet ported."""
    mp4v = samples(write(tmp_path / "a.avi", "XVID", pan((64, 48), 4)))
    p = tmp_path / "t.avi"
    if case in TOOLS:
        first = vol(64, 48, **TOOLS[case]) + mp4v[0][mp4v[0].index(b"\0\0\1\xb6"):]
        p.write_bytes(avi_of([(first, True)] + [(d, False) for d in mp4v[1:]], (64, 48), 25,
                             b"XVID"))
    elif case == "B-VOPs":  # the second VOP's coding type made 2
        d = bytearray(mp4v[1])
        k = d.index(b"\0\0\1\xb6") + 4
        d[k] = (d[k] & 0x3F) | 0x80
        p.write_bytes(avi_of([(mp4v[0], True), (bytes(d), False)], (64, 48), 25, b"XVID"))
    elif case == "packed":  # two coded VOPs in one sample
        p.write_bytes(avi_of([(mp4v[0], True), (mp4v[1] + mp4v[2], False)], (64, 48), 25,
                             b"XVID"))
    elif case == "short_video_header":  # an H.263 picture start code, no VOL
        p.write_bytes(avi_of([(b"\0\0\x80\x02" + bytes(60), True)], (64, 48), 25, b"XVID"))
    elif case == "V_VP9":
        p = write(tmp_path / "t.webm", "VP90", pan((64, 48), 3))
    elif case == "V_AV1":
        p = tmp_path / "t.webm"
        p.write_bytes(write(tmp_path / "v.webm", "VP80", pan((64, 48), 3)).read_bytes()
                      .replace(b"V_VP8", b"V_AV1"))
    elif case == "H264":
        p.write_bytes(write(tmp_path / "m.avi", "MJPG", pan((64, 48), 3)).read_bytes()
                      .replace(b"MJPG", b"H264"))
    elif case == "hvc1":
        p = tmp_path / "t.mp4"
        p.write_bytes(write(tmp_path / "m.mp4", "mp4v", pan((64, 48), 3)).read_bytes()
                      .replace(b"mp4v", b"hvc1", 1))
    else:  # MPEG-2 in an MP4: the esds object type 0x61
        data = write(tmp_path / "m.mp4", "mp4v", pan((64, 48), 3)).read_bytes()
        k = data.index(b"\x04\x80\x80\x80", data.index(b"esds")) + 5  # its object type
        assert data[k] == 0x20
        p = tmp_path / "t.mp4"
        p.write_bytes(data[:k] + b"\x61" + data[k + 1:])
    word = {"H264": "H.264", "hvc1": "HEVC"}.get(case, case)
    with pytest.raises(native.UnsupportedVideo, match=word) as e:
        r = VideoReader(p)
        r.read(range(r.frames))
    blocked = case in ("H264", "hvc1")
    assert ("Blocked" in str(e.value)) == blocked and "queue 1" in str(e.value)


# ---------------------------------------------------------------------------
# the predictor, JAX's writer and the tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,fourcc", [("mp4", "mp4v"), ("webm", "VP80")])
def test_predictor_matches_jax(flagship, tmp_path, ext, fourcc):  # noqa: F811
    """The predictor over the video equals JAX's; JAX's `save=True` output
    (an `mp4v` MP4) is read by the port as cv2 reads it."""
    pm, jm = flagship
    p = write(tmp_path / f"pan.{ext}", fourcc,
              panning_sequence(6, (72, 96), seed=5, tile=96)[0])
    kw = {"imgsz": IMGSZ, "conf": CONF}
    ours = DetectionPredictor(overrides={**kw, "device": "cpu"}).setup_model(pm)
    items = []
    ours.add_callback("on_predict_postprocess_end", lambda q: items.extend(q.batch_items))
    theirs = JaxPredictor(overrides={**kw, "save": True, "project": str(tmp_path),
                                     "name": "jax"})
    theirs.setup_model(jm, jm.variables)
    got, want = ours(p, batch=4), theirs(str(p), batch=4)
    assert [r.path for r in got] == [r.path for r in want] == [str(p)] * 6
    assert _same_results(got, want) > 0
    assert [(it["frame_idx"], it["is_video"], it["fps"]) for it in items] == \
        [(i, True, 25.0) for i in range(6)]
    saved = tmp_path / "jax" / "pan.mp4"
    assert_reads_as_cv2(saved)


def test_yolo_track_over_a_folder_of_both_matches_jax(tmp_path):
    """A folder with an `mp4v` MP4 and a VP8 WebM: one tracker per video,
    the tracks' IDs and classes equal JAX's, boxes within 1e-3 px."""
    d = tmp_path / "videos"
    d.mkdir()
    seq = panning_sequence(8, (240, 320), seed=7, tile=320)[0]
    write(d / "a.mp4", "mp4v", seq[:4])
    write(d / "b.webm", "VP80", seq[4:])
    y = port_model.YOLO(NPZ, device="cpu")
    got = y.track(str(d), imgsz=320, tracker="bytetrack.yaml")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        want = jax_model.YOLO(str(NPZ)).track(str(d), imgsz=320, tracker="bytetrack.yaml")
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 8
    assert _same_track_results(got, want) > 0
    assert sorted(y.predictor.trackers) == sorted(str(p) for p in d.iterdir())
