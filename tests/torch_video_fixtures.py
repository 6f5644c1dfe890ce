"""Write the committed video fixtures of `mgdt_yolo_tpu_torch/native/fixtures/
video/` (run from the repository's root, with cv2 and PIL):

    python tests/torch_video_fixtures.py

* `clip.avi`, `clip.mp4`, `clip.mkv`: 5 frames of a seeded 64x112 pan as
  Motion JPEG at 12.5 fps, written by `cv2.VideoWriter` (ffmpeg's encoder:
  the three hold the same JPEG bytes); `clip_<i>.png`: libjpeg's reading
  (`cv2.imdecode`) of frame i, the twin the card's nvJPEG reading is held
  to (`chip_smoke.py` phase 26);
* `clip.gif`: 4 frames of the pan quantised by PIL (local palettes,
  disposal 2, interlaced); `gif_<i>.png`: `cv2.VideoCapture`'s frame i,
  which the port's GIF decoder gives bit for bit;
* `pan1080.mp4` (`mp4v`: MPEG-4 Part 2, what the JAX package's `save=True`
  writes) and `pan1080.webm` (VP8): the same 20 frames of a seeded
  1920x1080 pan of synthetic scenes (blurred by a Gaussian of sigma 1, so
  each file stays near a megabyte), at 25 fps, written by
  `cv2.VideoWriter`; each spans two GOPs (an I-VOP or key frame every 12);
* `mpeg4_4mv.avi`: an MPEG-4 Part 2 stream that cv2's writer cannot make,
  with four motion vectors in some macroblocks (`flags=+mv4`) and video
  packets (`ps`): 24 frames of a 96x64 pan with a block moving against it,
  encoded by the libavcodec that cv2 bundles, driven through ctypes (cv2's
  writer takes no encoder options), and put in an AVI here;
* `vp8_v1_sharp.webm`, `vp8_v3.webm`, `vp8_resilient.webm`: 40 frames of
  a 64x48 pan as VP8 streams that cv2's writer does not make (version 1's
  bilinear filters and simple loop filter with sharpness 5, version 3's
  full-sample chroma, error resilience's per-frame segment maps and
  probabilities that are not kept), from the same libavcodec's `libvpx`
  encoder, put in a WebM here;
* `mpeg4_odd_height.avi`: 6 frames of a smooth 64x47 pan from the same
  libavcodec's `mpeg4` encoder; cv2 turns an odd height to BGR through
  swscale's scaler, not the port's arithmetic (ROADMAP queue 3, known
  differences), so only its luma is held;
* `codecs.json`: for each of these, cv2's fps, size and the SHA-256
  of every frame as `cv2.VideoCapture` reads it (BGR bytes), which the
  port's decoders give bit for bit (`tests/test_torch_video_codecs.py` on
  the CPU, `chip_smoke.py` phase 26 on the card's host).

`tests/test_torch_video.py` checks the twins against cv2 on the CPU.
"""
import ctypes
import glob
import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "mgdt_yolo_tpu_torch" / "native" / "fixtures" / "video"
SHAPE, FRAMES, FPS = (64, 112), 5, 12.5
PAN1080_FRAMES, PAN1080_BLUR, PAN1080_SEED = 20, 1.0, 3


def pan(n):
    from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
    return panning_sequence(n, SHAPE, seed=11, tile=SHAPE[1])[0]


MV4_W, MV4_H, MV4_FRAMES, MV4_FPS = 96, 64, 24, 25
MV4_OPTIONS = {"video_size": f"{MV4_W}x{MV4_H}", "pixel_format": "yuv420p",
               "time_base": f"1/{MV4_FPS}", "flags": "+mv4", "g": "12", "bf": "0", "ps": "120",
               "mbd": "rd", "threads": "1"}
AVFRAME_W, AVFRAME_H, AVFRAME_FORMAT = 104, 108, 116  # AVFrame's width, height, format
AVPACKET_DATA, AVPACKET_SIZE, AVPACKET_FLAGS = 24, 32, 40
YUV420P = 0


ODD_OPTIONS = {"video_size": "64x47", "pixel_format": "yuv420p", "time_base": "1/25",
               "g": "12", "threads": "1"}


def libavcodec():
    """The libavcodec cv2 bundles, with the encoder's functions typed."""
    libs = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    ctypes.CDLL(glob.glob(str(libs / "libavutil*"))[0], mode=ctypes.RTLD_GLOBAL)
    avc = ctypes.CDLL(glob.glob(str(libs / "libavcodec*"))[0])
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    for name, res, args in (
            ("avcodec_find_encoder_by_name", p, [s]), ("avcodec_alloc_context3", p, [p]),
            ("avcodec_open2", i, [p, p, p]), ("av_frame_alloc", p, []),
            ("av_frame_get_buffer", i, [p, i]), ("av_packet_alloc", p, []),
            ("avcodec_send_frame", i, [p, p]), ("avcodec_receive_packet", i, [p, p]),
            ("av_opt_set", i, [p, s, s, i])):
        f = getattr(avc, name)
        f.restype, f.argtypes = res, args
    return avc


def mv4_scenes():
    """A textured background panning left and a block moving against it, so
    the encoder splits some macroblocks into four vectors: I420 frames."""
    rng = np.random.default_rng(4)
    small = rng.integers(0, 256, (MV4_H // 4 + 4, (MV4_W + 3 * MV4_FRAMES) // 4 + 4, 3), np.uint8)
    bg = cv2.resize(small, None, fx=4, fy=4, interpolation=cv2.INTER_CUBIC)
    for k in range(MV4_FRAMES):
        img = np.ascontiguousarray(bg[k // 3:k // 3 + MV4_H, 3 * k:3 * k + MV4_W])
        x, y = 8 + 2 * k, 40 - k
        cv2.rectangle(img, (x, y), (x + 13, y + 11), (30, 200, 240), -1)
        yield cv2.cvtColor(img, cv2.COLOR_BGR2YUV_I420)


def encode(codec: bytes, options: dict, frames, size):
    """The packets (bytes, key frame) of I420 `frames` of `size` (w, h) from
    the bundled libavcodec's encoder `codec` with `options`."""
    avc = libavcodec()
    enc = avc.avcodec_find_encoder_by_name(codec)
    ctx = avc.avcodec_alloc_context3(enc)
    for k, v in options.items():
        if avc.av_opt_set(ctx, k.encode(), v.encode(), 1) < 0:
            raise RuntimeError(f"libavcodec refused the option {k}={v}")
    if avc.avcodec_open2(ctx, enc, None) < 0:
        raise RuntimeError(f"libavcodec could not open the encoder {codec}")
    (w, h), frame, pkt = size, avc.av_frame_alloc(), avc.av_packet_alloc()
    for off, val in ((AVFRAME_W, w), (AVFRAME_H, h), (AVFRAME_FORMAT, YUV420P)):
        ctypes.c_int.from_address(frame + off).value = val
    if avc.av_frame_get_buffer(frame, 32) < 0:
        raise RuntimeError("no frame buffer")
    data = (ctypes.c_void_p * 8).from_address(frame)
    lines = (ctypes.c_int * 8).from_address(frame + 64)
    packets = []

    def drain():
        while avc.avcodec_receive_packet(ctx, pkt) == 0:
            ptr = ctypes.c_void_p.from_address(pkt + AVPACKET_DATA).value
            n = ctypes.c_int.from_address(pkt + AVPACKET_SIZE).value
            key = ctypes.c_int.from_address(pkt + AVPACKET_FLAGS).value & 1
            packets.append((ctypes.string_at(ptr, n), bool(key)))

    ch = (h + 1) // 2  # chroma rows
    for i420 in frames:
        flat = np.ascontiguousarray(i420).reshape(-1)
        planes = (flat[:h * w].reshape(h, w),
                  flat[h * w:h * w + ch * (w // 2)].reshape(ch, w // 2),
                  flat[h * w + ch * (w // 2):].reshape(ch, w // 2))
        for p, plane in enumerate(planes):
            for r in range(plane.shape[0]):
                ctypes.memmove(data[p] + r * lines[p], plane[r].tobytes(), plane.shape[1])
        if avc.avcodec_send_frame(ctx, frame) < 0:
            raise RuntimeError("the encoder refused a frame")
        drain()
    avc.avcodec_send_frame(ctx, None)
    drain()
    return packets


def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def avi_of(packets, size, fps: int, fourcc: bytes = b"FMP4") -> bytes:
    """A one-stream AVI (RIFF, hdrl, movi, idx1 with key-frame flags) of
    `packets` (bytes, key frame), frames of `size` (w, h) at `fps`."""
    (w, h), n = size, len(packets)
    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0x10, n, 0, 1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0, n,
                       0, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)
    strl = b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)
    hdrl = b"hdrl" + chunk(b"avih", avih) + chunk(b"LIST", strl)
    movi, idx, off = b"movi", b"", 4
    for data, key in packets:
        c = chunk(b"00dc", data)
        idx += struct.pack("<4sIII", b"00dc", 0x10 if key else 0, off, len(data))
        movi += c
        off += len(c)
    body = b"AVI " + chunk(b"LIST", hdrl) + chunk(b"LIST", movi) + chunk(b"idx1", idx)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _ebml(i: int, body: bytes) -> bytes:
    return i.to_bytes((i.bit_length() + 7) // 8, "big") + b"\x01" + len(body).to_bytes(7, "big") \
        + body


def _uint(i: int, v: int) -> bytes:
    return _ebml(i, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def webm_of(frames, size, codec=b"V_VP8", ms=40) -> bytes:
    """A one-track WebM (EBML header, Info, Tracks, one Cluster of
    SimpleBlocks) of `frames` (bytes, key frame) of `size` (w, h)."""
    head = _ebml(0x1A45DFA3, _uint(0x4286, 1) + _uint(0x42F7, 1) + _uint(0x42F2, 4) +
                 _uint(0x42F3, 8) + _ebml(0x4282, b"webm") + _uint(0x4287, 2) +
                 _uint(0x4285, 2))
    info = _ebml(0x1549A966, _uint(0x2AD7B1, 1000000) + _ebml(0x4D80, b"t") +
                 _ebml(0x5741, b"t"))
    track = _uint(0xD7, 1) + _uint(0x73C5, 1) + _uint(0x83, 1) + _ebml(0x86, codec) + \
        _uint(0x23E383, ms * 1000000) + _ebml(0xE0, _uint(0xB0, size[0]) + _uint(0xBA, size[1]))
    blocks = b"".join(_ebml(0xA3, b"\x81" + struct.pack(">hB", k * ms, 0x80 if key else 0) + d)
                      for k, (d, key) in enumerate(frames))
    cluster = _ebml(0x1F43B675, _uint(0xE7, 0) + blocks)
    return head + _ebml(0x18538067, info + _ebml(0x1654AE6B, _ebml(0xAE, track)) + cluster)


# VP8 streams cv2's writer does not make, from libvpx (the bundled
# libavcodec's `libvpx` encoder): bilinear prediction and the simple loop
# filter with sharpness (version 1), full-sample chroma (version 3), and
# error resilience (segments with a map in every frame, probabilities not
# kept from frame to frame)
VP8_VARIANTS = {"vp8_v1_sharp.webm": {"profile": "1", "sharpness": "5"},
                "vp8_v3.webm": {"profile": "3"},
                "vp8_resilient.webm": {"deadline": "realtime", "cpu-used": "8",
                                       "error-resilient": "1"}}


def vp8_variants():
    """40 frames of the 4MV stream's pan at 64x48 in each VP8 variant."""
    rng = np.random.default_rng(5)
    small = rng.integers(0, 256, (20, 60, 3), np.uint8)
    bg = cv2.resize(small, None, fx=4, fy=4, interpolation=cv2.INTER_CUBIC)
    cv2.circle(bg, (120, 40), 14, (0, 255, 255), -1)
    frames = [cv2.cvtColor(np.ascontiguousarray(bg[k // 4:k // 4 + 48, 3 * k:3 * k + 64]),
                           cv2.COLOR_BGR2YUV_I420) for k in range(40)]
    base = {"video_size": "64x48", "pixel_format": "yuv420p", "time_base": "1/25",
            "b": "300k", "g": "24", "threads": "1"}
    for name, opts in VP8_VARIANTS.items():
        (OUT / name).write_bytes(webm_of(encode(b"libvpx", {**base, **opts}, frames, (64, 48)),
                                         (64, 48)))


def odd_height_frames(w=64, h=47, n=6):
    """`n` I420 frames (the Y plane, then U and V of (h + 1) // 2 rows) of
    a smooth seeded picture panning right, for a height cv2's writer does
    not make (it rounds sizes down to even)."""
    rng = np.random.default_rng(9)
    big = cv2.GaussianBlur(cv2.resize(rng.integers(0, 256, (12, 24, 3), np.uint8),
                                      (2 * w, h + 1), interpolation=cv2.INTER_CUBIC), (0, 0), 1)
    for k in range(n):
        yuv = cv2.cvtColor(np.ascontiguousarray(big[:, 2 * k:2 * k + w]), cv2.COLOR_BGR2YUV_I420)
        yield np.concatenate([yuv[:h].ravel(), yuv[h + 1:].ravel()])


def cv2_reading(path):
    """cv2's fps, size and the SHA-256 of every frame it reads of a video."""
    cap, digests, size = cv2.VideoCapture(str(path)), [], None
    while True:
        ok, img = cap.read()
        if not ok:
            break
        size = [img.shape[1], img.shape[0]]
        digests.append(hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest())
    return {"fps": cap.get(cv2.CAP_PROP_FPS), "size": size, "sha256": digests}


def pan1080():
    from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
    frames = panning_sequence(PAN1080_FRAMES, (1080, 1920), seed=PAN1080_SEED, tile=640)[0]
    return [cv2.GaussianBlur(f, (0, 0), PAN1080_BLUR) for f in frames]


def codecs():
    """The MPEG-4 Part 2 and VP8 fixtures and `codecs.json`."""
    out = {}
    frames = pan1080()
    for name, fourcc in (("pan1080.mp4", "mp4v"), ("pan1080.webm", "VP80")):
        vw = cv2.VideoWriter(str(OUT / name), cv2.VideoWriter_fourcc(*fourcc), 25, (1920, 1080))
        for f in frames:
            vw.write(f)
        vw.release()
        out[name] = cv2_reading(OUT / name)
    (OUT / "mpeg4_4mv.avi").write_bytes(
        avi_of(encode(b"mpeg4", MV4_OPTIONS, mv4_scenes(), (MV4_W, MV4_H)), (MV4_W, MV4_H), MV4_FPS))
    out["mpeg4_4mv.avi"] = {**cv2_reading(OUT / "mpeg4_4mv.avi"), "options": MV4_OPTIONS}
    (OUT / "mpeg4_odd_height.avi").write_bytes(avi_of(encode(
        b"mpeg4", {**ODD_OPTIONS}, odd_height_frames(), (64, 47)), (64, 47), 25))
    out["mpeg4_odd_height.avi"] = {**cv2_reading(OUT / "mpeg4_odd_height.avi"),
                                   "options": ODD_OPTIONS}
    vp8_variants()
    for name, opts in VP8_VARIANTS.items():
        out[name] = {**cv2_reading(OUT / name), "options": opts}
    (OUT / "codecs.json").write_text(json.dumps(out, indent=1) + "\n")


def main():
    from PIL import Image
    from mgdt_yolo_tpu_torch.native.video import VideoReader
    OUT.mkdir(parents=True, exist_ok=True)
    frames = pan(FRAMES)
    data = []
    for ext in ("avi", "mp4", "mkv"):
        p = OUT / f"clip.{ext}"
        vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"MJPG"), FPS,
                             (SHAPE[1], SHAPE[0]))
        for f in frames:
            vw.write(f)
        vw.release()
        r = VideoReader(p)
        data.append(r.frame_bytes(range(r.frames)))
    assert data[0] == data[1] == data[2], "the containers hold other frames"
    for i, b in enumerate(data[0]):
        cv2.imwrite(str(OUT / f"clip_{i}.png"),
                    cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR))
    ims = [Image.fromarray(f[..., ::-1]).quantize(200) for f in pan(4)]
    gif = OUT / "clip.gif"
    ims[0].save(gif, save_all=True, append_images=ims[1:], duration=[80, 40, 40, 120],
                loop=0, disposal=2)
    cap = cv2.VideoCapture(str(gif))
    i = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        cv2.imwrite(str(OUT / f"gif_{i}.png"), img)
        i += 1
    codecs()


if __name__ == "__main__":
    main()
