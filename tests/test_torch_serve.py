"""The port's micro-batching `InferenceServer` (`engine/serve.py`) on the CPU:
the three tests of the JAX package's `tests/test_serve.py` (coalescing with
results equal to the predictor's, a cancelled future that must not kill the
drainer, a lone request in a padded batch and a clean stop), a failed batch
that fails only its own requests, and the server against the JAX
package's `InferenceServer` on the same images and weights (the committed
flagship, the JAX model pinned to the windowed DCN).

Tolerances: against the port's predictor, the JAX test's own (2e-3 absolute
and 1e-3 relative on every value of a detection row, the same row count);
against JAX's server, the predictor tests' (counts and classes exact,
boxes 1e-3 px, scores 1e-5): the rows of a batch are computed apart, but a
batch padded to another size sums in another order on the CPU.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.serve import InferenceServer as JaxServer
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.engine.serve import InferenceServer, serve
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from test_torch_model import _nest
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NPZ = Path(__file__).resolve().parents[1] / "weights" / "mgdt_n_synth.npz"
SERVE = dict(imgsz=64, conf=1e-3, device="cpu")


@pytest.fixture(scope="module")
def served_model():
    return DetectionModel.from_npz(NPZ, device="cpu").fuse()


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    # varied sizes exercise each request's letterbox and scale_boxes
    sizes = [(96, 80), (64, 96), (72, 72), (80, 64)]
    return [rng.integers(0, 255, (*sizes[i % len(sizes)], 3), dtype=np.uint8)
            for i in range(n)]


def test_server_coalesces_and_matches_predictor(served_model):
    imgs = _images(8, seed=1)
    srv = serve(served_model, batch=4, max_wait_ms=200.0, iou=0.7, max_det=32, **SERVE)
    try:
        futs = [srv.submit(im) for im in imgs]
        results = [f.result(timeout=600) for f in futs]
    finally:
        srv.stop()

    assert len(results) == 8
    assert srv.stats["requests"] == 8
    # 8 requests submitted faster than the wait window must coalesce
    assert srv.stats["batches"] <= 4
    assert srv.mean_occupancy > 1.0
    lat = srv.latency_ms()
    assert lat["n"] == 8 and lat["p50"] > 0

    # the predictor's results on the same images and settings
    p = DetectionPredictor(overrides={"imgsz": 64, "conf": 1e-3, "iou": 0.7, "max_det": 32,
                                      "device": "cpu"})
    ref = p.setup_model(served_model)(imgs, batch=4)
    assert len(ref) == 8
    for r_srv, r_ref in zip(results, ref):
        a, b = r_srv.boxes.data, r_ref.boxes.data
        assert a.shape == b.shape
        if a.size:
            np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-3)


def test_cancelled_future_does_not_kill_drainer(served_model):
    """A caller may cancel() a pending Future; resolving it raises
    InvalidStateError, which must not take down the drain loop (every later
    request would then hang forever)."""
    srv = serve(served_model, batch=4, max_wait_ms=50.0, **SERVE)
    try:
        imgs = _images(3, seed=3)
        f_cancel = srv.submit(imgs[0])
        f_keep = srv.submit(imgs[1])
        f_cancel.cancel()  # legal: never set_running_or_notify_cancel'd
        assert f_keep.result(timeout=600) is not None
        # the server must still serve new requests afterwards
        assert srv.predict(imgs[2]) is not None
    finally:
        srv.stop()
    assert f_cancel.cancelled()


def test_server_short_batch_and_restartless_stop(served_model):
    srv = serve(served_model, batch=4, max_wait_ms=1.0, **SERVE)
    try:
        r = srv.predict(_images(1, seed=2)[0])  # a lone request: a padded batch
        assert r is not None
        assert srv.stats["batches"] == 1 and srv.stats["requests"] == 1
    finally:
        srv.stop()
    # a second stop does nothing; a submit after stop raises
    srv.stop()
    with pytest.raises(RuntimeError):
        srv.submit(_images(1)[0])


def test_failed_batch_fails_only_its_requests(served_model):
    """A request that cannot be letterboxed fails its batch's futures; the
    server serves the next batch, and a stop drains what is in flight."""
    with InferenceServer(served_model, batch=2, max_wait_ms=200.0, **SERVE) as srv:
        bad = srv.submit(np.zeros((8, 8), np.uint8))  # no channel axis
        mate = srv.submit(_images(1, seed=4)[0])
        with pytest.raises(Exception):
            bad.result(timeout=600)
        with pytest.raises(Exception):
            mate.result(timeout=600)
        late = [srv.submit(im) for im in _images(3, seed=5)]
    assert all(len(f.result(timeout=0).boxes.data.shape) == 2 for f in late)
    assert srv.stats["requests"] == 3  # the failed batch was never dispatched


def test_server_matches_jax_server(served_model):
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    with np.load(str(NPZ)) as f:
        jm.variables = _nest({k: f[k] for k in f.files})
    imgs = _images(6, seed=6)
    kw = dict(batch=4, max_wait_ms=200.0, imgsz=64, conf=1e-3, iou=0.7, max_det=32)
    theirs = JaxServer(jm, **kw).start()
    try:
        want = [f.result(timeout=600) for f in [theirs.submit(im) for im in imgs]]
    finally:
        theirs.stop()
    with InferenceServer(served_model, device="cpu", **kw) as ours:
        got = [f.result(timeout=600) for f in [ours.submit(im) for im in imgs]]
    assert sum(len(r) for r in got) > 0
    for g, w in zip(got, want):
        a, b = g.boxes.data, np.asarray(w.boxes.data)
        assert a.shape == b.shape and tuple(g.orig_shape) == tuple(w.orig_shape)
        np.testing.assert_array_equal(a[:, 5], b[:, 5])
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-5)


def test_server_device_is_explicit(served_model):
    """The server's device is the model's; without CUDA the default raises."""
    with pytest.raises(ValueError, match="the model is on"):
        InferenceServer(served_model, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceServer(served_model)
