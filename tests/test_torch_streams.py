"""HTTP Motion JPEG streams and screenshots as inference sources, against
the JAX package's `LoadStreams` (`cv2.VideoCapture`, ffmpeg's mpjpeg
demuxer) and `LoadScreenshots` (mss), on the CPU.

* Streams: a loopback HTTP server in a thread serves a
  `multipart/x-mixed-replace` stream, as IP cameras do; the port's items
  (count, `path`, `frame_idx`, `is_video`, `fps`) equal JAX's at
  `vid_stride` 1, 2 and 3, and each item's JPEG is the frame the server
  sent (read by libjpeg, it holds to JAX's frame as a video's frames do,
  `tests/test_torch_video.py`). Webcams, RTSP and RTMP raise, naming what
  is missing; a stream that cannot be opened raises `ConnectionError` in
  both.
* Screenshots: with a stand-in `mss` module, the port's items and capture
  region equal JAX's for each form of `screen [n] [left top width height]`;
  without `mss` both raise the same `ImportError`.
"""
import http.server
import logging
import sys
import threading
import types

import cv2
import numpy as np
import pytest

from mgdt_yolo_tpu.data.loaders import LoadScreenshots as JaxScreenshots
from mgdt_yolo_tpu.data.loaders import LoadStreams as JaxStreams
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.data.loaders import LoadScreenshots, LoadStreams, load_inference_source
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.utils import draw
from test_torch_dataset import scene
from test_torch_predict import flagship  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_video import GREY_LEVELS, READING_PSNR_DB, _grey

FRAMES = [cv2.imencode(".jpg", scene(48, 64, i), [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
          for i in range(7)]


class _Camera(http.server.BaseHTTPRequestHandler):
    """/stream: the frames as a multipart stream (with Content-Length);
    /bare: the same without it; anything else: 404."""

    def do_GET(self):
        if self.path not in ("/stream", "/bare"):
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
        self.end_headers()
        for j in FRAMES:
            head = b"--frame\r\nContent-Type: image/jpeg\r\n"
            if self.path == "/stream":
                head += b"Content-Length: %d\r\n" % len(j)
            self.wfile.write(head + b"\r\n" + j + b"\r\n")
        self.wfile.write(b"--frame--\r\n")

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def camera():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Camera)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join()


KEYS = ("path", "frame_idx", "is_video", "fps")


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("route", ["/stream", "/bare"])
def test_stream_items_equal_jax(camera, route, stride):
    url = camera + route
    want = list(JaxStreams(url, stride))
    got = list(load_inference_source(url, stride).entries())
    assert len(got) == len(want) == len(FRAMES) // stride
    assert [{k: g[k] for k in KEYS} for g in got] == [{k: w[k] for k in KEYS} for w in want]
    for g, w in zip(got, want):
        assert g["data"] == FRAMES[(g["frame_idx"] + 1) * stride - 1]
        img = cv2.imdecode(np.frombuffer(g["data"], np.uint8), cv2.IMREAD_COLOR)
        assert np.abs(_grey(img) - _grey(w["img"])).max() <= GREY_LEVELS
        assert draw.psnr_db(img, w["img"]) >= READING_PSNR_DB


def test_streams_the_port_does_not_read_raise(camera):
    for source, word in (("0", "webcam"), ("3", "V4L2"), ("rtsp://cam/1", "rtsp"),
                         ("rtmp://host/live", "rtmp")):
        with pytest.raises(NotImplementedError, match=word):
            load_inference_source(source)
    for loader in (LoadStreams(camera + "/missing"), JaxStreams(camera + "/missing")):
        with pytest.raises(ConnectionError, match="failed to open stream"):
            list(loader)


def test_the_predictor_over_a_stream(flagship, camera, caplog):  # noqa: F811
    """On the card the predictor reads the stream's frames (phase 26); here,
    without nvJPEG, the stream ends at its first frame, with a warning."""
    if native.has_jpeg():
        pytest.skip("this machine decodes JPEG")
    pm, _ = flagship
    p = DetectionPredictor(overrides={"imgsz": 64, "device": "cpu"}).setup_model(pm)
    with caplog.at_level(logging.WARNING):
        assert p(camera + "/stream") == []
    assert any("CUDA device" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# screenshots, with a stand-in mss
# ---------------------------------------------------------------------------

class _Shot:
    """What mss's `grab` returns: an array-like of BGRA pixels."""

    def __init__(self, mon):
        self.mon = dict(mon)

    def __array__(self, dtype=None, copy=None):
        m = self.mon
        rng = np.random.default_rng(m["left"] * 7919 + m["top"] * 31 + m["width"])
        return rng.integers(0, 256, (m["height"], m["width"], 4), dtype=np.uint8)


class _MSS:
    monitors = [{"left": 0, "top": 0, "width": 96, "height": 64},
                {"left": 10, "top": 5, "width": 48, "height": 40},
                {"left": 96, "top": 0, "width": 32, "height": 24}]

    def grab(self, mon):
        return _Shot(mon)


SCREENS = ["screen", "screen 1", "screen 4 6 20 12", "screen 2 3 1 16 8", "screen 1 2"]


@pytest.mark.parametrize("source", SCREENS)
def test_screenshot_items_equal_jax(monkeypatch, source):
    fake = types.ModuleType("mss")
    fake.mss = _MSS
    monkeypatch.setitem(sys.modules, "mss", fake)
    ours, theirs = load_inference_source(source), JaxScreenshots(source, max_frames=3)
    assert isinstance(ours, LoadScreenshots)
    ours.max_frames = 3
    assert ours.monitor == theirs.monitor and ours.screen == theirs.screen
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert {k: g[k] for k in KEYS} == {k: w[k] for k in KEYS}
        np.testing.assert_array_equal(g["img"], w["img"])


def test_screenshots_without_mss_raise_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "mss", None)
    with pytest.raises(ImportError) as ours:
        load_inference_source("screen 0")
    with pytest.raises(ImportError) as theirs:
        JaxScreenshots("screen 0")
    assert str(ours.value) == str(theirs.value)
