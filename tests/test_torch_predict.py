"""The port's serving entry points against the JAX package's (CPU, float32):
`Results` and `Boxes`, test-time augmentation (`predict_augment`) and the
`DetectionPredictor` end to end, on the committed flagship weights
(`weights/mgdt_n_synth.npz`) and, for TTA on a three-level head, on
`yolov8.yaml` from JAX's seeded variables with randomised norm statistics.
The JAX models are pinned to the windowed DCN. Tolerances:

* `Results` and `Boxes` on the same detection rows: every property,
  `counts()`, `verbose()`, the `save_txt` file and `tojson`, exact (the same
  numpy and Python arithmetic);
* `predict_augment` at 96 px: the same anchor count, the decoded tensor to
  1e-4 of its magnitude (at least 1), as `tests/test_torch_model.py` holds
  the raw maps (float32 sums in another order; the bilinear resizes of
  `F.interpolate` and `jax.image.resize` differ by float32 rounding);
* the predictor over BGR images of varied sizes at batch 2 (a short last
  batch), images whose letterbox is exact (ratio 1 or an integer
  down-ratio, checked equal first) so that the model is what is compared,
  and once with both predictors given JAX's letterboxed batch: the number of
  detections and their classes exact, boxes in the original image's pixels
  to 1e-3 px, scores to 1e-5 (the validator's limits).
"""
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from mgdt_yolo_tpu.engine.predictor import letterbox_batch as jax_letterbox_batch
from mgdt_yolo_tpu.engine.results import Results as JaxResults
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor, letterbox_batch
from mgdt_yolo_tpu_torch.engine.results import Results
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.weights import load_jax_variables, load_state
from test_torch_model import _nest, _randomize
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NPZ = Path(__file__).resolve().parents[1] / "weights" / "mgdt_n_synth.npz"
IMGSZ = 96
CONF = 0.01
RTOL_DECODED = 1e-4
ATOL_BOX, ATOL_SCORE = 1e-3, 1e-5
# images whose letterbox to 96 is exact: pad only, 2x and 3x down (cv2's
# INTER_AREA path and one tap), tall and wide
EXACT_SIZES = [(96, 64), (192, 128), (288, 288), (48, 96), (96, 72)]
# sizes whose resize has fractional taps
OTHER_SIZES = [(100, 75), (61, 97), (130, 130)]


def _images(sizes, seed):
    """Seeded BGR scenes: a grey-noise ground with a few coloured blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        img = rng.integers(90, 150, (h, w, 3), dtype=np.uint8)
        for _ in range(3):
            y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
            img[y:y + h // 3, x:x + w // 3] = rng.integers(0, 256, 3)
        out.append(img)
    return out


@pytest.fixture(scope="module")
def flagship():
    """(port model, JAX holder with the same variables)."""
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    with np.load(str(NPZ)) as f:
        jm.variables = _nest({k: f[k] for k in f.files})
    return DetectionModel.from_npz(NPZ, device="cpu"), jm


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.path == w.path and tuple(g.orig_shape) == tuple(w.orig_shape)
        a, b = g.boxes.data, np.asarray(w.boxes.data)
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_array_equal(a[:, 5], b[:, 5])
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=ATOL_BOX)
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=ATOL_SCORE)
    return sum(len(g) for g in got)


# ---------------------------------------------------------------------------
# Results and Boxes
# ---------------------------------------------------------------------------

def _rows(n, cols, shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    xy = rng.uniform(0, [w, h], (n, 2))
    wh = rng.uniform(1, 40, (n, 2))
    rows = [np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)]
    if cols == 7:
        rows.append(rng.integers(1, 9, (n, 1)))
    rows += [rng.uniform(0, 1, (n, 1)), rng.integers(0, 3, (n, 1))]
    return np.concatenate(rows, 1).astype(np.float32)


@pytest.mark.parametrize("n,cols", [(0, 6), (7, 6), (5, 7)])
def test_results_and_boxes_match_jax(n, cols, tmp_path):
    shape = (60, 90)
    img = np.zeros((*shape, 3), np.uint8)
    rows = _rows(n, cols, shape, seed=n)
    names = {0: "person", 1: "car", 2: "2"}
    got, want = Results(img, "a.jpg", names, rows), JaxResults(img, "a.jpg", names, rows)
    for prop in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls", "data"):
        np.testing.assert_array_equal(getattr(got.boxes, prop), getattr(want.boxes, prop), prop)
    assert got.boxes.is_track == want.boxes.is_track and (cols == 7) == got.boxes.is_track
    if cols == 7:
        np.testing.assert_array_equal(got.boxes.id, want.boxes.id)
    assert len(got) == len(want) == n and got.keys == want.keys
    assert got.counts() == want.counts() and got.verbose() == want.verbose()
    for normalize in (False, True):
        assert got.tojson(normalize) == want.tojson(normalize)
    for save_conf in (False, True):
        got.save_txt(tmp_path / "g.txt", save_conf)
        want.save_txt(tmp_path / "w.txt", save_conf)
        assert (tmp_path / "g.txt").read_text() == (tmp_path / "w.txt").read_text()
    if n:
        np.testing.assert_array_equal(got[1:3].boxes.data, want[1:3].boxes.data)
        np.testing.assert_array_equal(got.boxes[::2].xywhn, want.boxes[::2].xywhn)
    assert len(got.new()) == 0 and got.cpu() is got and got.boxes.numpy() is got.boxes
    assert len(got.update(rows[:1] if n else None)) == min(n, 1)


# ---------------------------------------------------------------------------
# test-time augmentation
# ---------------------------------------------------------------------------

def _yolov8_pair():
    jm = JaxDetectionModel("yolov8.yaml", nc=2)
    flat = _randomize(jm.variables, seed=3)
    pm = DetectionModel("yolov8.yaml", nc=2, device="cpu")
    load_state(pm, load_jax_variables(flat))
    return pm.eval(), jm, _nest(flat)


@pytest.mark.parametrize("name", ["flagship", "yolov8"])
def test_predict_augment_matches_jax(name, flagship):
    if name == "flagship":
        pm, jm = flagship
        variables = jm.variables
    else:
        pm, jm, variables = _yolov8_pair()
    x = np.random.default_rng(5).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.predict_augment(x, variables=v)[0])(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got, none = pm.predict_augment(torch.from_numpy(x))
    assert none is None and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL_DECODED * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# the predictor end to end
# ---------------------------------------------------------------------------

PREDICT_CASES = {"plain": {}, "augment": {"augment": True}, "agnostic": {"agnostic_nms": True}}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predictor_matches_jax(case, flagship, tmp_path):
    pm, jm = flagship
    imgs = _images(EXACT_SIZES, seed=11)
    got_x, got_meta = letterbox_batch(imgs, IMGSZ)
    want_x, want_meta = jax_letterbox_batch(imgs, IMGSZ)
    np.testing.assert_array_equal(got_x, want_x)
    assert got_meta == want_meta
    kw = {"imgsz": IMGSZ, "conf": CONF, **PREDICT_CASES[case], "save_txt": True,
          "project": str(tmp_path)}
    ours = DetectionPredictor(overrides={**kw, "device": "cpu", "name": "port"})
    ours.setup_model(pm)
    theirs = JaxPredictor(overrides={**kw, "save": False, "name": "jax"})
    theirs.setup_model(jm, jm.variables)
    got, want = ours(imgs, batch=2), theirs(imgs, batch=2)
    assert _same_results(got, want) > 0
    assert all(set(r.speed) == {"preprocess", "inference", "postprocess"} for r in got)
    # the label files: classes exact, normalised boxes to the boxes' limit
    # over the smallest image side plus the files' 6 significant digits
    for i in range(len(imgs)):
        a, b = (np.loadtxt(tmp_path / who / "labels" / f"array{i}.txt", ndmin=2)
                for who in ("port", "jax"))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=ATOL_BOX / 48 + 1e-6)


def test_predictor_on_jax_letterboxed_batch(flagship):
    """Images with fractional resize taps, both predictors given JAX's
    (cv2's) letterboxed batch."""
    pm, jm = flagship
    imgs = _images(OTHER_SIZES, seed=12)
    ours = DetectionPredictor(overrides={"imgsz": IMGSZ, "conf": CONF, "device": "cpu"})
    ours.setup_model(pm)
    ours.preprocess = lambda batch: jax_letterbox_batch(batch, IMGSZ)
    theirs = JaxPredictor(overrides={"imgsz": IMGSZ, "conf": CONF, "save": False})
    theirs.setup_model(jm, jm.variables)
    assert _same_results(ours(imgs, batch=2), theirs(imgs, batch=2)) > 0


def test_predictor_streams_and_half(flagship):
    """`stream=True` yields the list's results one by one; `half` serves in
    bf16 (a model of its own: setup folds and casts in place)."""
    pm, _ = flagship
    imgs = _images(EXACT_SIZES[:3], seed=13)
    p = DetectionPredictor(overrides={"imgsz": IMGSZ, "conf": CONF, "device": "cpu"})
    p.setup_model(pm)
    listed, streamed = p(imgs, batch=2), list(p(imgs, stream=True, batch=2))
    for a, b in zip(listed, streamed):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    half = DetectionPredictor(overrides={"imgsz": IMGSZ, "half": True, "device": "cpu"})
    model = half.setup_model(DetectionModel.from_npz(NPZ, device="cpu")).model
    assert next(model.parameters()).dtype == torch.bfloat16 and model.n_fused > 0
    r = half(imgs[0])[0]
    assert r.boxes.data.dtype == np.float32 and np.isfinite(r.boxes.data).all()


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255 ** 2 / mse) if mse else np.inf


def test_unported_sources_and_outputs_raise(flagship, tmp_path):
    pm, _ = flagship
    p = DetectionPredictor(overrides={"imgsz": IMGSZ, "device": "cpu"}).setup_model(pm)
    # file sources are read since the from-disk path (`tests/test_torch_loaders.py`):
    # missing ones raise as JAX's loader does; streams need a video decoder
    for source in ("bus.jpg", Path("images"), ["a.jpg"]):
        with pytest.raises(FileNotFoundError):
            p(source)
    for source in (0, "rtsp://camera/1"):
        with pytest.raises(NotImplementedError, match="queue 1"):
            p(source)
    with pytest.raises(ValueError, match="uint8"):
        p(np.zeros((8, 8, 3), np.float32))
    # `save` and `save_crop` are drawn and written since the drawing slice
    # (`tests/test_torch_plotting.py` holds the drawing to JAX's)
    imgs = _images(EXACT_SIZES[:2], seed=5)
    saver = DetectionPredictor(overrides={"imgsz": IMGSZ, "conf": 0.001, "device": "cpu",
                                          "save": True, "save_crop": True,
                                          "project": str(tmp_path), "name": "p"})
    results = saver.setup_model(pm)(imgs)
    out = tmp_path / "p"
    for r in results:
        stem = Path(r.path).stem
        written, drawn = cv2.imread(str(out / f"{stem}.jpg")), r.plot()
        assert written.shape == r.orig_img.shape
        cv2_q95 = cv2.imdecode(cv2.imencode(".jpg", drawn)[1], cv2.IMREAD_COLOR)
        assert _psnr(written, drawn) >= _psnr(cv2_q95, drawn) - 0.5
        for c in {int(v) for v in r.boxes.cls}:
            assert (out / "crops" / str(r.names.get(c, c)) / f"{stem}.jpg").is_file()
    assert sum(len(r) for r in results) > 0
    r = Results(np.zeros((4, 4, 3), np.uint8), "a.jpg", {})
    np.testing.assert_array_equal(r.plot(), r.orig_img)
    r.save_crop(tmp_path / "empty")
    assert not (tmp_path / "empty").exists()
    with pytest.raises(SyntaxError):
        DetectionPredictor(overrides={"confidence": 0.5, "device": "cpu"})
    with pytest.raises(ValueError, match="the model is on"):
        DetectionPredictor(overrides={"device": "cpu"}).setup_model(
            type("M", (), {"device": torch.device("meta")})())
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DetectionPredictor()
