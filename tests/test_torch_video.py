"""Video files as inference sources, and the predictor's video writer,
against the JAX package (`cv2.VideoCapture` / `cv2.VideoWriter`, ffmpeg) on
the CPU.

* Items: the port's `LoadImagesAndVideos` over Motion JPEG in AVI (cv2's,
  and AVI1-style frames without Huffman tables, without `idx1`, and split
  over an OpenDML `AVIX` RIFF, built here), MP4 as ffmpeg writes it (`mp4v`
  sample entry, object type 0x6C), MOV, MKV and an MP4 whose edit list
  starts two frames in or ends early, at `vid_stride` 1, 2 and 3: count,
  `path`, `frame_idx`, `is_video` and `fps` equal to JAX's items.
* Frames: here the decoder has no nvJPEG, so a Motion JPEG frame's bytes
  (the port's demuxed frame) are read by libjpeg (`cv2.imdecode`) and held
  to JAX's frame (ffmpeg's reading): BT.601 grey within `GREY_LEVELS` and
  the colour within a PSNR of `READING_PSNR_DB` dB. The two decoders differ
  by ffmpeg's IDCT (the grey) and swscale's chroma upsampling and YCbCr
  conversion (the colour: mean ~2.6 grey levels on these scenes). On the
  card nvJPEG's reading is held to libjpeg's (`chip_smoke.py` phase 26).
* GIF frames (composed on the host here as on the card): bit for bit JAX's,
  with global and local palettes, interlace, transparency and every
  disposal method, and its fps.
* What is not ported raises `UnsupportedVideo`, naming the codec.
* The predictor and `YOLO.track` over GIF videos against JAX's: the
  predictor's limits (counts exact, boxes 1e-3 px, scores 1e-5), track IDs
  and classes equal, one tracker per video path.
* The writer: `save=True` writes `<stem>.mp4`, which cv2 reads with JAX's
  frame count, fps and size; each frame within `draw.jpeg_reading`'s bound
  of `Results.plot()`.
"""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

import mgdt_yolo_tpu.engine.model as jax_model
from mgdt_yolo_tpu.data.loaders import LoadImagesAndVideos as JaxLoader
from mgdt_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.data.loaders import LoadImagesAndVideos, load_inference_source
from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
from mgdt_yolo_tpu_torch.engine import model as port_model
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.native.video import VideoReader, VideoWriter, writer_rate
from mgdt_yolo_tpu_torch.utils import draw
from test_torch_dataset import scene
from test_torch_predict import CONF, IMGSZ, NPZ, _same_results, flagship  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_tracker import _same_track_results

# libjpeg's and ffmpeg's readings of one frame: their BT.601 grey's max |diff|
# (measured: 2 on ffmpeg's own Motion JPEG, 6 on libjpeg's 4:2:0 files, where
# the colour's rounding and clipping reach the grey), and the PSNR of one
# against the other (measured: 30.0 dB and above)
GREY_LEVELS = 8
READING_PSNR_DB = 28.0
STRIDES = (1, 2, 3)


# ---------------------------------------------------------------------------
# writers of what cv2 does not write
# ---------------------------------------------------------------------------

def gif_lzw(indices: bytes, min_code: int) -> bytes:
    """GIF's LZW (LSB first; codes widen once the table reaches their
    width's size; a clear code where the table fills)."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    out, acc, nacc, bits = bytearray(), 0, 0, min_code + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    table, nxt = {bytes([i]): i for i in range(clear)}, eoi + 1
    emit(clear)
    w = b""
    for c in indices:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if nxt < 4096:
            table[wc], nxt = nxt, nxt + 1
            if nxt > (1 << bits) and bits < 12:
                bits += 1
        else:
            emit(clear)
            table, nxt, bits = {bytes([i]): i for i in range(clear)}, eoi + 1, min_code + 1
        w = bytes([c])
    if w:
        emit(table[w])
        nxt += 1
        if nxt > (1 << bits) and bits < 12:
            bits += 1
    emit(eoi)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _depth(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def gif_bytes(size, frames, global_pal=None, bg=0, version=b"GIF89a") -> bytes:
    """A GIF of `frames`: dicts of `idx` ((h, w) palette indices), `left`,
    `top`, `pal` (a local palette), `transparent`, `disposal`, `delay`
    (1/100 s; None: no graphic control extension) and `interlace`."""
    w, h = size
    out = bytearray(version + struct.pack("<HH", w, h))
    if global_pal is not None:
        d = _depth(len(global_pal))
        out += bytes([0x80 | 0x70 | (d - 1), bg, 0])
        out += np.resize(global_pal, (1 << d, 3)).astype(np.uint8).tobytes()
    else:
        out += bytes([0x70, 0, 0])
    for f in frames:
        idx = f["idx"]
        fh, fw = idx.shape
        if f.get("delay") is not None:
            t = f.get("transparent")
            out += bytes([0x21, 0xF9, 4, (f.get("disposal", 0) << 2) | (t is not None)])
            out += struct.pack("<H", f["delay"]) + bytes([t or 0, 0])
        flags = 0x40 if f.get("interlace") else 0
        pal = f.get("pal")
        n = len(pal) if pal is not None else len(global_pal)
        d = _depth(max(n, int(idx.max()) + 1))
        if pal is not None:
            flags |= 0x80 | (d - 1)
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), fw, fh, flags)
        if pal is not None:
            out += np.resize(pal, (1 << d, 3)).astype(np.uint8).tobytes()
        rows = idx
        if f.get("interlace"):
            rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        mc = max(2, d)
        data = gif_lzw(rows.astype(np.uint8).tobytes(), mc)
        out += bytes([mc]) + b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                                      for i in range(0, len(data), 255)) + b"\0"
    return bytes(out + b"\x3b")


def _gif_case(name: str) -> bytes:
    rng = np.random.default_rng(sum(map(ord, name)))
    W, H = 41, 29
    pal = rng.integers(0, 256, (16, 3))

    def idx(h, w, k=16):
        a = rng.integers(0, k, (h, w))
        a[: h // 2, : w // 3] = 3  # flat runs for the LZW
        return a

    if name == "global-disposal-0-1":
        frames = [dict(idx=idx(H, W), delay=4),
                  dict(idx=idx(10, 12), left=5, top=4, delay=8, disposal=1),
                  dict(idx=idx(7, 30), left=11, top=20, delay=4)]
    elif name == "disposal-2":
        frames = [dict(idx=idx(H, W), delay=5, disposal=2),
                  dict(idx=idx(12, 14), left=3, top=2, delay=5, disposal=2),
                  dict(idx=idx(12, 14), left=20, top=9, delay=5, disposal=2, transparent=3),
                  dict(idx=idx(6, 6), left=1, top=1, delay=5)]
    elif name == "disposal-3":
        frames = [dict(idx=idx(H, W), delay=3),
                  dict(idx=idx(15, 20), left=4, top=6, delay=3, disposal=3),
                  dict(idx=idx(15, 20), left=10, top=10, delay=3, disposal=3, transparent=5),
                  dict(idx=idx(8, 8), left=30, top=0, delay=3)]
    elif name == "transparent-first-frame":
        frames = [dict(idx=idx(H, W), delay=4, transparent=3),
                  dict(idx=idx(H - 4, W - 6), left=2, top=3, delay=6, transparent=0)]
    elif name == "local-palettes-interlaced":
        frames = [dict(idx=idx(H, W, 4), pal=rng.integers(0, 256, (4, 3)), delay=7,
                       interlace=True),
                  dict(idx=idx(23, 37, 200), pal=rng.integers(0, 256, (256, 3)), delay=7,
                       left=2, top=3, interlace=True),
                  dict(idx=idx(H, W), delay=0, interlace=True)]
    elif name == "no-gce-frames":  # as far as ffmpeg parses them as frames
        frames = [dict(idx=idx(H, W), delay=None), dict(idx=idx(H, W), delay=6),
                  dict(idx=idx(9, 9), left=3, top=3, delay=None)]
    elif name == "gif87a":  # a still: GIF87a has no extensions, so no animation
        return gif_bytes((W, H), [dict(idx=idx(H, W))], pal, version=b"GIF87a")
    elif name == "background-index":
        frames = [dict(idx=idx(10, 10), left=4, top=4, delay=2),
                  dict(idx=idx(10, 10), left=20, top=12, delay=2, disposal=2)]
        return gif_bytes((W, H), frames, pal, bg=7) + b""
    else:  # PIL's: quantised frames, optimised sub-rectangles, interlaced
        from PIL import Image
        seq = panning_sequence(5, (48, 64), seed=2, tile=64)[0]
        ims = [Image.fromarray(f[..., ::-1]).quantize(64) for f in seq]
        import io
        buf = io.BytesIO()
        ims[0].save(buf, format="GIF", save_all=True, append_images=ims[1:],
                    duration=[40, 80, 40, 40, 60], loop=0, disposal=2, optimize=False)
        return buf.getvalue()
    return gif_bytes((W, H), frames, pal)


GIF_CASES = ["global-disposal-0-1", "disposal-2", "disposal-3", "transparent-first-frame",
             "local-palettes-interlaced", "no-gce-frames", "gif87a", "background-index", "pil"]


def _strip_dht(jpeg: bytes) -> bytes:
    """A JPEG without its Huffman tables (an AVI1-style Motion JPEG frame)."""
    out, p = bytearray(jpeg[:2]), 2
    while True:
        m, n = jpeg[p + 1], struct.unpack(">H", jpeg[p + 2:p + 4])[0]
        if m == 0xDA:
            return bytes(out + jpeg[p:])
        if m != 0xC4:
            out += jpeg[p:p + 2 + n]
        p += 2 + n


def avi_bytes(jpegs, size, rate=25, scale=1, index=True, avix_from=None) -> bytes:
    """A Motion JPEG AVI of `jpegs`: with `idx1`, or without it (read by a
    scan), or with the frames from `avix_from` on in an OpenDML `AVIX` RIFF."""
    w, h = size

    def chunk(cid, body):
        return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    def lst(kind, body):
        return chunk(b"LIST", kind + body)

    n = len(jpegs)
    avih = struct.pack("<14I", 1000000 * scale // rate, 0, 0, 0x10 if index else 0, n, 0, 1,
                       0, w, h, 0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, scale, rate, 0, n, 0,
                                     0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) +
                                                   chunk(b"strf", strf)))
    first = jpegs if avix_from is None else jpegs[:avix_from]
    movi, idx, off = b"", b"", 4
    for j in first:
        c = chunk(b"00dc", j)
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(j))
        movi += c
        off += len(c)
    body = b"AVI " + hdrl + lst(b"movi", movi) + (chunk(b"idx1", idx) if index else b"")
    out = chunk(b"RIFF", body)
    if avix_from is not None:
        out += chunk(b"RIFF", b"AVIX" + lst(b"movi", b"".join(chunk(b"00dc", j)
                                                              for j in jpegs[avix_from:])))
    return out


def _jpegs(frames, quality=90):
    return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
            for f in frames]


def _patch_mp4(data: bytes, media_frames: int, span_frames: int = None) -> bytes:
    """An ffmpeg MP4 with its edit list starting `media_frames` frames in
    (and lasting `span_frames` frames, else to the end)."""
    i = data.index(b"elst")
    ver_flags, n, seg, media = struct.unpack(">IIIi", data[i + 4:i + 20])
    j = data.index(b"mdhd")
    ts = struct.unpack(">I", data[j + 16:j + 20])[0]
    k = data.index(b"stts")
    delta = struct.unpack(">I", data[k + 16:k + 20])[0]
    m = data.index(b"mvhd")
    movie_ts = struct.unpack(">I", data[m + 16:m + 20])[0]
    if span_frames is not None:
        seg = span_frames * delta * movie_ts // ts
    else:
        seg -= media_frames * delta * movie_ts // ts
    return data[:i + 12] + struct.pack(">Ii", seg, media_frames * delta) + data[i + 20:]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The Motion JPEG files of the item tests, by name."""
    root = tmp_path_factory.mktemp("clips")
    frames = panning_sequence(7, (72, 104), seed=4, tile=104)[0]
    size = (104, 72)
    out = {}
    for ext, fps in (("avi", 12.5), ("mp4", 29.97), ("mov", 25.0), ("mkv", 30.0)):
        p = root / f"cv2.{ext}"
        vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
        for f in frames:
            vw.write(f)
        vw.release()
        out[f"cv2-{ext}"] = p
    js = _jpegs(frames)
    for name, kw in (("avi1-no-dht", dict(rate=30000, scale=1001)),
                     ("avi-no-index", dict(index=False, rate=15)),
                     ("avi-avix", dict(index=False, avix_from=4, rate=10))):
        p = root / f"{name}.avi"
        frames_ = [_strip_dht(j) for j in js] if name == "avi1-no-dht" else js
        p.write_bytes(avi_bytes(frames_, size, **kw))
        out[name] = p
    data = out["cv2-mp4"].read_bytes()
    for name, args in (("mp4-edit-starts-late", (2,)), ("mp4-edit-ends-early", (0, 5))):
        p = root / f"{name}.mp4"
        p.write_bytes(_patch_mp4(data, *args))
        out[name] = p
    return out


CLIPS = ["cv2-avi", "cv2-mp4", "cv2-mov", "cv2-mkv", "avi1-no-dht", "avi-no-index", "avi-avix",
         "mp4-edit-starts-late", "mp4-edit-ends-early"]
KEYS = ("path", "frame_idx", "is_video", "fps")


def _grey(img):
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.int16)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("clip", CLIPS)
def test_motion_jpeg_items_equal_jax(clips, clip, stride):
    path = clips[clip]
    want = list(JaxLoader(str(path), stride))
    src = LoadImagesAndVideos(str(path), stride)
    got = list(src.entries())
    assert len(got) == len(want) > 0, (len(got), len(want))
    assert [{k: g[k] for k in KEYS} for g in got] == [{k: w[k] for k in KEYS} for w in want]
    reader = src.readers[str(path)]
    for e, w, data in zip(got, want, reader.frame_bytes([e["frame"] for e in got])):
        if clip == "avi1-no-dht":
            assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
            data = native.jpeg_standard_dht(data)
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert img.shape == w["img"].shape
        assert np.abs(_grey(img) - _grey(w["img"])).max() <= GREY_LEVELS, e
        assert draw.psnr_db(img, w["img"]) >= READING_PSNR_DB, e


def test_motion_jpeg_on_the_cpu_ends_with_a_warning(clips, caplog):
    """Without a CUDA device the first JPEG frame cannot be read (nvJPEG):
    the video ends there, with a warning naming why, as a video ends at a
    frame it cannot read; on the card these frames are decoded."""
    if native.has_jpeg():
        pytest.skip("this machine decodes JPEG")
    items = list(LoadImagesAndVideos(str(clips["cv2-avi"])))
    assert items == []
    assert any("CUDA device" in r.message and "ends at frame 0" in r.message
               for r in caplog.records)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_frames_equal_jax(tmp_path, case, stride):
    path = tmp_path / f"{case}.gif"
    path.write_bytes(_gif_case(case))
    want = list(JaxLoader(str(path), stride))
    got = list(LoadImagesAndVideos(str(path), stride))
    assert len(got) == len(want) and (want or stride > 1)
    for g, w in zip(got, want):
        assert {k: g[k] for k in KEYS} == {k: w[k] for k in KEYS}
        np.testing.assert_array_equal(g["img"], w["img"], err_msg=f"{case} {g['frame_idx']}")


@pytest.mark.parametrize("delays", [[4, 8, 4, 4], [4, 4, 8], [0, 0, 0], [1, 1], [3, 7, 3],
                                    [6, 6, 6, 100], [None, 6, None], [2, 3, 4, 5, 6],
                                    [None, 1, None]])
def test_gif_fps_equals_jax(tmp_path, delays):
    """cv2's fps of a GIF: 100 over the floor of its mean delay, at least 1
    (a GIF delay of 0 counts 10, a frame without a control extension 0)."""
    rng = np.random.default_rng(len(delays))
    frames = [dict(idx=rng.integers(0, 4, (6, 8)), delay=d) for d in delays]
    path = tmp_path / "a.gif"
    path.write_bytes(gif_bytes((8, 6), frames, rng.integers(0, 256, (4, 3))))
    cap = cv2.VideoCapture(str(path))
    assert VideoReader(path).fps == cap.get(cv2.CAP_PROP_FPS)
    assert VideoReader(path).frames == len(delays)


def _mp4_with_entry(data: bytes, fourcc: bytes) -> bytes:
    return data.replace(b"mp4v", fourcc, 1)


@pytest.mark.parametrize("case", ["mpeg4-bvop", "avc1", "hvc1", "fragmented", "vp9-webm",
                                  "avi-h264", "mkv-h264", "interlaced"])
def test_unported_videos_raise_naming_the_codec(clips, tmp_path, case):
    data = clips["cv2-mp4"].read_bytes()
    if case == "mpeg4-bvop":  # cv2's mp4v with its second VOP made a B-VOP
        p = tmp_path / "a.mp4"
        vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 48))
        for i in range(3):
            vw.write(scene(48, 64, i))
        vw.release()
        b = bytearray(p.read_bytes())
        k = b.index(b"\0\0\1\xb6", b.index(b"\0\0\1\xb6") + 4) + 4
        b[k] = (b[k] & 0x3F) | 0x80
        p.write_bytes(bytes(b))
        word = "B-VOPs"
    elif case in ("avc1", "hvc1"):
        p = tmp_path / "a.mp4"
        p.write_bytes(_mp4_with_entry(data, case.encode()))
        word = case
    elif case == "fragmented":
        p = tmp_path / "a.mp4"
        p.write_bytes(data + struct.pack(">I", 8) + b"moof")
        word = "fragmented"
    elif case == "vp9-webm":
        p = tmp_path / "a.webm"
        vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"VP90"), 25, (64, 48))
        for i in range(3):
            vw.write(scene(48, 64, i))
        vw.release()
        word = "V_VP9"
    elif case == "avi-h264":
        p = tmp_path / "a.avi"
        p.write_bytes(clips["cv2-avi"].read_bytes().replace(b"MJPG", b"H264"))
        word = "H264"
    elif case == "mkv-h264":
        p = tmp_path / "a.mkv"
        p.write_bytes(clips["cv2-mkv"].read_bytes().replace(b"V_MJPEG", b"V_MPEGH"))
        word = "V_MPEGH"
    else:  # two fields a frame
        js = _jpegs(panning_sequence(3, (36, 104), seed=4, tile=104)[0])
        p = tmp_path / "a.avi"
        p.write_bytes(avi_bytes([j + j for j in js], (104, 72)))
        word = "two fields"
    with pytest.raises(native.UnsupportedVideo, match=word):
        load_inference_source(p)


# ---------------------------------------------------------------------------
# the predictor, the tracker and the writer over GIF videos
# ---------------------------------------------------------------------------

def _pan_gif(path: Path, n: int, shape, seed: int, delay: int = 4):
    from PIL import Image
    seq = panning_sequence(n, shape, seed=seed, tile=max(shape))[0]
    ims = [Image.fromarray(f[..., ::-1]).quantize(255) for f in seq]
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=delay * 10, loop=0)
    return path


def test_predictor_over_a_gif_matches_jax(flagship, tmp_path):  # noqa: F811
    pm, jm = flagship
    gif = _pan_gif(tmp_path / "pen.gif", 6, (72, 96), seed=5)
    kw = {"imgsz": IMGSZ, "conf": CONF}
    ours = DetectionPredictor(overrides={**kw, "device": "cpu"}).setup_model(pm)
    items = []
    ours.add_callback("on_predict_postprocess_end", lambda p: items.extend(p.batch_items))
    theirs = JaxPredictor(overrides={**kw, "save": False})
    theirs.setup_model(jm, jm.variables)
    got, want = ours(gif, batch=4), theirs(str(gif), batch=4)
    n = len(want)  # PIL merges frames that do not change
    assert [r.path for r in got] == [r.path for r in want] == [str(gif)] * n and n >= 4
    assert _same_results(got, want) > 0
    assert [(it["frame_idx"], it["is_video"], it["fps"]) for it in items] == \
        [(i, True, 25.0) for i in range(n)]


def test_yolo_track_over_videos_matches_jax(tmp_path):
    """Two GIF videos in a folder: one tracker per video path, in the port as
    in JAX; the tracks' IDs and classes equal, boxes within 1e-3 px."""
    d = tmp_path / "videos"
    d.mkdir()
    for k in range(2):
        _pan_gif(d / f"pen{k}.gif", 4, (240, 320), seed=k + 1)
    y = port_model.YOLO(NPZ, device="cpu")
    got = y.track(str(d), imgsz=320, tracker="bytetrack.yaml")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        want = jax_model.YOLO(str(NPZ)).track(str(d), imgsz=320, tracker="bytetrack.yaml")
    assert [r.path for r in got] == [r.path for r in want]
    assert _same_track_results(got, want) > 0
    assert sorted(y.predictor.trackers) == sorted(str(p) for p in d.glob("*.gif"))


def test_save_writes_an_mp4_cv2_reads_as_jax_s(flagship, tmp_path):  # noqa: F811
    pm, jm = flagship
    gif = _pan_gif(tmp_path / "pen.gif", 5, (72, 96), seed=6, delay=7)
    kw = {"imgsz": IMGSZ, "conf": CONF, "save": True, "project": str(tmp_path)}
    ours = DetectionPredictor(overrides={**kw, "device": "cpu", "name": "port"}).setup_model(pm)
    got = ours(gif, batch=2)
    theirs = JaxPredictor(overrides={**kw, "name": "jax"})
    theirs.setup_model(jm, jm.variables)
    theirs(str(gif), batch=2)
    mine, jaxs = tmp_path / "port" / "pen.mp4", tmp_path / "jax" / "pen.mp4"
    assert mine.is_file() and jaxs.is_file() and not ours._video_writers

    def read(p):
        cap = cv2.VideoCapture(str(p))
        n = 0
        while cap.grab():
            n += 1
        return n, cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_WIDTH), \
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT)
    n, fps = len(got), VideoReader(gif).fps
    rate, base = writer_rate(fps)
    assert read(mine) == read(jaxs) == (n, rate / base, 96.0, 72.0) and n >= 4
    reader = VideoReader(mine)
    assert (reader.frames, reader.fps, reader.size) == (n, rate / base, (96, 72))
    for r, data in zip(got, reader.frame_bytes(range(n))):
        drawn = r.plot()
        back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        lib = cv2.imdecode(cv2.imencode(".jpg", drawn)[1], cv2.IMREAD_COLOR)
        assert draw.jpeg_reading(back, drawn, lib)["holds"]


@pytest.mark.parametrize("fps", [25.0, 29.97, 100 / 7, 100 / 29, 12.5, 0.5])
def test_writer_rate_is_cv2_s(tmp_path, fps):
    """The writer's fps as cv2's writer makes it a fraction, read back at the
    same fps by cv2 and by the port."""
    p = tmp_path / "a.mp4"
    w = VideoWriter(p, fps, (32, 16))
    for i in range(3):
        w.write(scene(16, 32, i))
    w.release()
    rate, base = writer_rate(fps)
    cap = cv2.VideoCapture(str(p))
    assert cap.get(cv2.CAP_PROP_FPS) == rate / base == VideoReader(p).fps
    assert abs(rate / base - fps) <= 1e-3
    with pytest.raises(ValueError, match="frame of"):
        VideoWriter(tmp_path / "b.mp4", fps, (32, 16)).write(scene(8, 8, 0))


def test_committed_fixtures_are_cv2_s():
    """The committed clips (`tests/torch_video_fixtures.py`): cv2's frame
    count and fps, one set of Motion JPEG frames in the three containers,
    their twins libjpeg's readings, the GIF's twins its frames, which the
    port composes bit for bit."""
    fix = Path(native.__file__).parent / "fixtures" / "video"
    frames = None
    for ext in ("avi", "mp4", "mkv"):
        r = VideoReader(fix / f"clip.{ext}")
        cap = cv2.VideoCapture(str(fix / f"clip.{ext}"))
        assert (r.frames, r.fps) == (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS))
        got = r.frame_bytes(range(r.frames))
        assert frames is None or got == frames
        frames = got
    for i, b in enumerate(frames):
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR),
                                      native.decode(fix / f"clip_{i}.png"))
    r = VideoReader(fix / "clip.gif")
    twins = sorted(fix.glob("gif_*.png"))
    assert r.frames == len(twins) == 4
    for img, twin in zip(r.read(range(r.frames)), twins):
        np.testing.assert_array_equal(img, native.decode(twin))
