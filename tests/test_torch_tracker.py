"""The port's trackers (`tracker/`) against the JAX package's on the CPU:
the Kalman filters, the assignment and its costs, ByteTrack and BoT-SORT
(camera motion off) over a seeded 120-frame sequence of detections, the
scenarios of JAX's `tests/test_tracker.py`, the predictor's callbacks with
batched frames, and `YOLO.track` / `yolo track` over frames from the
committed weights. Limits, each with its reason:

* the Kalman filters: 1e-9 (the same float64 operations);
* the assignment: the same matches and unmatched lists; the costs 1e-6
  (the same float32 IoU);
* the trackers over detections: IDs, classes and detection rows equal,
  boxes and scores 1e-4 (float64 states, float32 outputs, the same
  operations: equal bits seen);
* `YOLO.track`: IDs equal, boxes 1e-3 px (the detector's limit against
  JAX's, `tests/test_torch_predict.py`, carried through the filter).

The ID counter belongs to the class, in JAX and here: a new tracker
resets the numbering of every stream (`test_a_new_tracker_resets_every_
streams_ids`, which also pins what an ID drawn twice does). BoT-SORT with
its camera-motion compensation is held in `tests/test_torch_gmc.py`.
"""
import logging
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

import mgdt_yolo_tpu.cfg as jax_cfg
import mgdt_yolo_tpu.engine.model as jax_model
import mgdt_yolo_tpu.tracker.bot_sort as JB
import mgdt_yolo_tpu.tracker.byte_tracker as JT
import mgdt_yolo_tpu.tracker.kalman as JK
import mgdt_yolo_tpu.tracker.matching as JM
import mgdt_yolo_tpu.tracker.track as JTR
import mgdt_yolo_tpu_torch.cfg as port_cfg
import mgdt_yolo_tpu_torch.engine.model as port_model
import mgdt_yolo_tpu_torch.tracker.bot_sort as PB
import mgdt_yolo_tpu_torch.tracker.byte_tracker as PT
import mgdt_yolo_tpu_torch.tracker.kalman as PK
import mgdt_yolo_tpu_torch.tracker.matching as PM
import mgdt_yolo_tpu_torch.tracker.track as PTR
from mgdt_yolo_tpu.engine.results import Results as JaxResults
from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
from mgdt_yolo_tpu_torch.engine.predictor import DetectionPredictor
from mgdt_yolo_tpu_torch.engine.results import Results
from test_torch_cli import _run, _same_calls
from test_torch_predict import NPZ
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

JAX = SimpleNamespace(K=JK, M=JM, T=JT, B=JB, TR=JTR, Results=JaxResults)
PORT = SimpleNamespace(K=PK, M=PM, T=PT, B=PB, TR=PTR, Results=Results)
SIDES = [PORT, JAX]
FRAMES, TRACK_IMGSZ, TRACK_SHAPE = 8, 320, (240, 320)
GMC_IMGSZ = 160  # `orb` and `sift` through the facade


# ---------------------------------------------------------------------------
# Kalman filters and assignment
# ---------------------------------------------------------------------------

def _states(rng, n, kind):
    xy = rng.uniform(0, 600, (n, 2))
    h = rng.uniform(10, 120, (n, 1))
    third = (rng.uniform(0.3, 2.0, (n, 1)) if kind == "KalmanFilterXYAH"
             else rng.uniform(10, 120, (n, 1)))  # the aspect, or the width
    return np.concatenate([xy, third, h], 1)


@pytest.mark.parametrize("kind", ["KalmanFilterXYAH", "KalmanFilterXYWH"])
def test_kalman_filters_match_jax(kind):
    rng = np.random.default_rng(0)
    got, want = getattr(PK, kind)(), getattr(JK, kind)()
    meas = _states(rng, 6, kind)
    for z in meas:
        m, c = got.initiate(z)
        mw, cw = want.initiate(z)
        np.testing.assert_allclose(m, mw, rtol=0, atol=1e-9)
        np.testing.assert_allclose(c, cw, rtol=0, atol=1e-9)
        m[4:] = mw[4:] = rng.normal(0, 2, 4)
        for _ in range(3):
            m, c = got.predict(m, c)
            mw, cw = want.predict(mw, cw)
        for a, b in zip(got.project(m, c), want.project(mw, cw)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        z2 = z + rng.normal(0, 3, 4)
        for a, b in zip(got.update(m, c, z2), want.update(mw, cw, z2)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        for only, metric in ((False, "maha"), (True, "maha"), (False, "gaussian")):
            np.testing.assert_allclose(got.gating_distance(m, c, meas, only, metric),
                                       want.gating_distance(mw, cw, meas, only, metric),
                                       rtol=0, atol=1e-9)
    # multi_predict: JAX's, and each row the single predict
    means = np.concatenate([meas, rng.normal(0, 2, (6, 4))], 1)
    covs = np.stack([got.initiate(z)[1] for z in meas])
    pm, pc = got.multi_predict(means.copy(), covs.copy())
    wm, wc = want.multi_predict(means.copy(), covs.copy())
    np.testing.assert_allclose(pm, wm, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pc, wc, rtol=0, atol=1e-9)
    for i in range(len(means)):
        sm, sc = got.predict(means[i].copy(), covs[i].copy())
        np.testing.assert_allclose(pm[i], sm, rtol=0, atol=1e-9)
        np.testing.assert_allclose(pc[i], sc, rtol=0, atol=1e-9)
    e = got.multi_predict(np.zeros((0, 8)), np.zeros((0, 8, 8)))
    assert e[0].shape == (0, 8) and e[1].shape == (0, 8, 8)


@pytest.mark.parametrize("shape", [(7, 5), (5, 7), (1, 4), (0, 3), (3, 0), (6, 6)])
@pytest.mark.parametrize("thresh", [0.2, 0.5, 0.8])
def test_linear_assignment_matches_jax(shape, thresh):
    cost = np.random.default_rng(shape[0] * 7 + shape[1]).uniform(0, 1, shape)
    got, want = PM.linear_assignment(cost, thresh), JM.linear_assignment(cost, thresh)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    assert got[1] == want[1] and got[2] == want[2]


def _tracks(mod, rng, n, feat=False):
    out = []
    for _ in range(n):
        x, y = rng.uniform(0, 300, 2)
        w, h = rng.uniform(10, 80, 2)
        t = mod.B.BOTrack([x, y, w, h], rng.uniform(0.1, 1), int(rng.integers(0, 3)),
                          rng.normal(0, 1, 16) if feat else None)
        out.append(t)
    return out


def test_costs_match_jax():
    for n_a, n_b in ((5, 7), (0, 3), (4, 0)):
        a = [_tracks(s, np.random.default_rng(1), n_a, True) for s in SIDES]
        b = [_tracks(s, np.random.default_rng(2), n_b, True) for s in SIDES]
        for fn in ("iou_distance", "embedding_distance"):
            got, want = getattr(PM, fn)(a[0], b[0]), getattr(JM, fn)(a[1], b[1])
            assert got.shape == want.shape == (n_a, n_b) and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(PM.embedding_distance(a[0], b[0], "euclidean"),
                                   JM.embedding_distance(a[1], b[1], "euclidean"), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(PM.fuse_score(PM.iou_distance(a[0], b[0]), b[0]),
                                   JM.fuse_score(JM.iou_distance(a[1], b[1]), b[1]), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the trackers over a seeded sequence of detections
# ---------------------------------------------------------------------------

def detection_sequence(n_frames=120, seed=0):
    """Per frame (boxes (n, 4) xyxy float32, scores (n,), cls (n,)) of a
    seeded scene: objects born and dying at their own frames, moving at
    their own speeds, a pair crossing, a low-confidence band (0.15-0.45),
    detections under 0.1, occlusions of 4, 12, 25 and 45 frames (around the
    30-frame buffer), jittered boxes, shuffled rows."""
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(9):
        birth = int(rng.integers(0, 40))
        objs.append(dict(birth=birth, death=int(rng.integers(birth + 30, n_frames + 20)),
                         p=rng.uniform([40, 40], [560, 400]), v=rng.uniform(-4, 4, 2),
                         wh=rng.uniform([25, 30], [90, 110]), cls=int(rng.integers(0, 3)),
                         gaps=[], low=[]))
    # a crossing pair on one row, and occlusions of several lengths
    objs[0].update(birth=0, death=n_frames, p=np.array([60.0, 200]), v=np.array([4.0, 0]))
    objs[1].update(birth=0, death=n_frames, p=np.array([540.0, 205]), v=np.array([-4.0, 0]))
    for k, (start, length) in enumerate([(20, 4), (30, 12), (35, 25), (40, 45)]):
        objs[2 + k].update(birth=0, death=n_frames, gaps=[(start, start + length)])
    objs[6]["low"] = [(15, 35)]
    objs[7]["low"] = [(50, 58), (70, 72)]
    frames = []
    for t in range(n_frames):
        boxes, scores, cls = [], [], []
        for o in objs:
            if not o["birth"] <= t < o["death"] or any(a <= t < b for a, b in o["gaps"]):
                continue
            c = o["p"] + o["v"] * (t - o["birth"]) + rng.normal(0, 0.8, 2)
            wh = o["wh"] * (1 + rng.normal(0, 0.02, 2))
            boxes.append(np.concatenate([c - wh / 2, c + wh / 2]))
            low = any(a <= t < b for a, b in o["low"])
            scores.append(rng.uniform(0.15, 0.45) if low else rng.uniform(0.62, 0.95))
            cls.append(o["cls"])
        for _ in range(int(rng.integers(0, 3))):  # clutter under the low band
            c = rng.uniform([0, 0], [640, 480])
            boxes.append(np.concatenate([c, c + rng.uniform(10, 40, 2)]))
            scores.append(rng.uniform(0.01, 0.09))
            cls.append(int(rng.integers(0, 3)))
        order = rng.permutation(len(boxes))
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4)[order],
                       np.asarray(scores)[order], np.asarray(cls, float)[order]))
    return frames


def _tracker(side, kind):
    if kind == "bytetrack":
        return side.T.BYTETracker()
    return side.B.BOTSORT(SimpleNamespace(
        track_high_thresh=0.5, track_low_thresh=0.1, new_track_thresh=0.6, track_buffer=30,
        match_thresh=0.8, gmc_method="none", proximity_thresh=0.5, appearance_thresh=0.25,
        with_reid=False))


def _same_tracks(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(got[:, [4, 6, 7]], want[:, [4, 6, 7]], err_msg=what)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-4, err_msg=what)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("kind", ["bytetrack", "botsort"])
def test_trackers_over_120_frames_match_jax(kind):
    seq = detection_sequence()
    img = np.zeros((480, 640, 3), np.uint8)
    got, want = _tracker(PORT, kind), _tracker(JAX, kind)
    ids = set()
    for t, (b, s, c) in enumerate(seq):
        g = got.update(b, s, c, img)
        w = want.update(b, s, c, img)
        _same_tracks(g, w, f"frame {t}")
        ids |= set(g[:, 4].astype(int).tolist())
        assert len(got.lost_stracks) == len(want.lost_stracks)
        assert len(got.removed_stracks) == len(want.removed_stracks)
    # the sequence exercises births, losses, re-finds past short gaps and
    # new IDs after the 45-frame one
    assert len(ids) > 9 and len(got.removed_stracks) > 0


def test_a_new_tracker_resets_every_streams_ids():
    """JAX's semantics, kept: `STrack._count` is the class's, so a tracker
    made for stream B restarts the numbering stream A draws from too."""
    def run(side):
        a = side.T.BYTETracker()
        boxes = np.array([[10, 10, 50, 60], [200, 40, 260, 120]], np.float32)
        for t in range(4):
            a.update(boxes + 2 * t, np.array([0.9, 0.8]), np.array([0.0, 1.0]))
        b = side.T.BYTETracker()
        out_b = [b.update(np.array([[300, 300, 340, 350]], np.float32) + t, np.array([0.9]),
                          np.array([0.0])) for t in range(3)]
        third = np.concatenate([boxes + 8, [[400, 200, 450, 260]]]).astype(np.float32)
        out_a = [a.update(third + t, np.array([0.9, 0.8, 0.9]), np.array([0.0, 1.0, 2.0]))
                 for t in range(3)]
        return out_a, out_b
    got, want = run(PORT), run(JAX)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _same_tracks(g, w, "reset")
    assert sorted(got[1][-1][:, 4].tolist()) == [1.0]
    # stream A's next birth draws ID 2, which A's own track holds: the
    # de-duplication by ID (`joint_stracks`) drops the newcomer, and the
    # detection is born again as 3 on the next frame
    assert [sorted(o[:, 4].tolist()) for o in got[0]] == [[1.0, 2.0], [1.0, 2.0],
                                                          [1.0, 2.0, 3.0]]


# ---------------------------------------------------------------------------
# the scenarios of JAX's tests/test_tracker.py, each on both sides
# ---------------------------------------------------------------------------

def _moving_boxes(t, n=2):
    out = []
    for i in range(n):
        x = 20 + 50 * i + 3 * t * (i + 1)
        y = 30 + 40 * i
        out.append([x, y, x + 25, y + 25])
    return np.asarray(out, np.float32)


def scenario_kalman_velocity(m, tmp):
    kf = m.K.KalmanFilterXYAH()
    mean, cov = kf.initiate(np.array([10.0, 10.0, 1.0, 20.0]))
    mean[4] = 2.0
    mean2, cov2 = kf.predict(mean, cov)
    assert np.isclose(mean2[0], 12.0) and np.trace(cov2) > np.trace(cov)
    mean3, _ = kf.update(mean2, cov2, np.array([14.0, 10.0, 1.0, 20.0]))
    assert 10.0 < mean3[0] <= 14.0
    return [mean2, cov2, mean3]


def scenario_id_stability(m, tmp):
    tr = m.T.BYTETracker()
    outs = [tr.update(_moving_boxes(t), np.array([0.9, 0.85]), np.array([0.0, 1.0]))
            for t in range(10)]
    ids = {tuple(sorted(o[:, 4].astype(int))) for o in outs[1:]}
    assert len(ids) == 1
    return outs


def scenario_low_conf_rescue(m, tmp):
    tr = m.T.BYTETracker()
    outs = [tr.update(_moving_boxes(t, 1), np.array([0.9]), np.array([0.0])) for t in range(5)]
    outs.append(tr.update(_moving_boxes(5, 1), np.array([0.3]), np.array([0.0])))
    assert len(outs[-1]) == 1
    return outs


def scenario_lost_then_removed(m, tmp):
    tr = m.T.BYTETracker()
    outs = [tr.update(_moving_boxes(t, 1), np.array([0.9]), np.array([0.0])) for t in range(3)]
    outs += [tr.update(np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0)) for _ in range(3)]
    assert len(outs[-1]) == 0 and len(tr.lost_stracks) >= 1
    return outs


def scenario_botsort_gmc(m, tmp):
    tr = m.B.BOTSORT()
    img = np.random.default_rng(0).integers(0, 255, (120, 160, 3), dtype=np.uint8)
    outs = [tr.update(_moving_boxes(t), np.array([0.9, 0.8]), np.array([0.0, 1.0]), img)
            for t in range(4)]
    assert len(outs[-1]) == 2
    return outs


def scenario_bundled_yaml(m, tmp):
    a, b = m.TR.load_tracker_cfg("bytetrack"), m.TR.load_tracker_cfg("botsort.yaml")
    assert a.tracker_type == "bytetrack" and b.gmc_method == "sparseOptFlow"
    return [dict(a), dict(b), a.get("track_high_thresh"), a.get("missing", 3)]


def scenario_custom_yaml(m, tmp):
    custom = tmp / "mytracker.yaml"
    custom.write_text("tracker_type: bytetrack\ntrack_high_thresh: 0.9\n"
                      "track_low_thresh: 0.2\nnew_track_thresh: 0.7\n"
                      "track_buffer: 15\nmatch_thresh: 0.6\n")
    pred = SimpleNamespace(args=SimpleNamespace(tracker=str(custom)))
    m.TR.on_predict_start(pred)
    tr = m.TR.tracker_for(pred, "__frames__")
    assert isinstance(tr, m.T.BYTETracker) and m.TR.tracker_for(pred, "__frames__") is tr
    pred.args.tracker = "botsort.yaml"  # persist keeps the table and the configuration
    m.TR.on_predict_start(pred, persist=True)
    assert m.TR.tracker_for(pred, "__frames__") is tr
    return [dict(tr.args), tr.max_time_lost]


def scenario_unknown_type(m, tmp):
    bad = tmp / "bad.yaml"
    bad.write_text("tracker_type: deepsort\n")
    errors = []
    for spec in (str(bad), "no_such_tracker.yaml"):
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            m.TR.load_tracker_cfg(spec)
        errors.append(type(e.value).__name__)
    with pytest.raises(ValueError) as e:
        m.TR.load_tracker_cfg(str(bad))
    return [errors, str(e.value)]


def scenario_stream_isolation(m, tmp):
    pred = SimpleNamespace(args=SimpleNamespace(tracker="bytetrack.yaml"))
    m.TR.on_predict_start(pred)
    t0, t1 = m.TR.tracker_for(pred, "a.mp4"), m.TR.tracker_for(pred, "b.mp4")
    assert len(pred.trackers) == 2 and t0 is not t1
    outs = []
    for t in range(6):
        outs.append(t0.update(_moving_boxes(t, 1), np.array([0.9]), np.array([0.0])))
        box1 = np.asarray([[300.0, 300 + 2 * t, 340, 340 + 2 * t]], np.float32)
        outs.append(t1.update(box1, np.array([0.9]), np.array([0.0])))
    assert abs(t0.tracked_stracks[0].tlwh[1] - 30) < 10 and t1.tracked_stracks[0].tlwh[1] > 250
    return outs


def scenario_batched_frames(m, tmp):
    img = np.zeros((96, 96, 3), np.uint8)
    pred = SimpleNamespace(args=SimpleNamespace(tracker="bytetrack.yaml"))
    m.TR.on_predict_start(pred)
    outs, frame = [], 0
    for _ in range(4):
        results, items = [], []
        for _ in range(3):
            det = np.concatenate([_moving_boxes(frame), [[0.9], [0.85]], [[0.0], [1.0]]],
                                 axis=1).astype(np.float32)
            results.append(m.Results(img, "video.mp4", {0: "a", 1: "b"}, det))
            items.append({"img": img, "path": "video.mp4", "frame_idx": frame,
                          "is_video": True})
            frame += 1
        pred.results, pred.batch_items = results, items
        m.TR.on_predict_postprocess_end(pred)
        outs += [np.asarray(r.boxes.data) for r in results]
    assert len(pred.trackers) == 1
    assert len({tuple(sorted(o[:, 4].astype(int))) for o in outs if len(o) == 2}) == 1
    return outs


SCENARIOS = [scenario_kalman_velocity, scenario_id_stability, scenario_low_conf_rescue,
             scenario_lost_then_removed, scenario_botsort_gmc, scenario_bundled_yaml,
             scenario_custom_yaml, scenario_unknown_type, scenario_stream_isolation,
             scenario_batched_frames]


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[9:] for s in SCENARIOS])
def test_jax_tracker_scenarios(scenario, tmp_path):
    want = scenario(JAX, tmp_path)
    got = scenario(PORT, tmp_path)
    _same(got, want)


# ---------------------------------------------------------------------------
# the predictor, the facade and the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    return panning_sequence(FRAMES, TRACK_SHAPE, seed=1, tile=TRACK_IMGSZ)[0]


@pytest.fixture(scope="module")
def frame_dir(frames, tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    for t, f in enumerate(frames):
        cv2.imwrite(str(root / f"frame_{t:03d}.png"), f)
    return root


@pytest.fixture(scope="module")
def jax_tracks(frames, frame_dir):
    with pytest.MonkeyPatch.context() as mp:  # JAX's predictor may save into runs/
        mp.chdir(frame_dir.parent)
        y = jax_model.YOLO(str(NPZ))
        return (y.track(list(frames), imgsz=TRACK_IMGSZ),
                y.track(str(frame_dir), imgsz=TRACK_IMGSZ, tracker="bytetrack.yaml"))


def _same_track_results(got, want, atol=1e-3):
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        a, b = g.boxes.data, np.asarray(w.boxes.data)
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.shape[1] == 7:
            np.testing.assert_array_equal(a[:, 4], b[:, 4])
            np.testing.assert_array_equal(a[:, 6], b[:, 6])
            n += len(a)
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=atol)
    return n


def test_yolo_track_over_frames_and_a_folder_matches_jax(frames, frame_dir, jax_tracks):
    y = port_model.YOLO(NPZ, device="cpu")
    got = y.track(list(frames), imgsz=TRACK_IMGSZ)
    assert _same_track_results(got, jax_tracks[0]) >= FRAMES
    assert all(r.boxes.is_track for r in got[1:])
    assert isinstance(y.predictor.trackers["__frames__"], PB.BOTSORT)
    got = y.track(str(frame_dir), imgsz=TRACK_IMGSZ, tracker="bytetrack.yaml")
    assert [r.path for r in got] == [r.path for r in jax_tracks[1]]
    assert _same_track_results(got, jax_tracks[1]) >= FRAMES
    assert isinstance(y.predictor.trackers["__frames__"], PT.BYTETracker)
    assert y.predictor.args.conf == 0.1
    rec = got[-1].tojson()
    assert '"track_id"' in rec


def test_batched_frames_reach_one_tracker_in_order(frames):
    """`batch` 3 over 8 frames: the callback runs once per batch (3, 3, 2
    frames), in frame order, with `batch_items`, and the tracks are those of
    `batch` 1."""
    model = port_model.YOLO(NPZ, device="cpu")
    single = model.track(list(frames), imgsz=TRACK_IMGSZ)
    pred = DetectionPredictor({"imgsz": TRACK_IMGSZ, "conf": 0.1, "device": "cpu"})
    pred.setup_model(model.predictor.model)
    PTR.register_tracker(pred)
    seen = []
    pred.add_callback("on_predict_postprocess_end",
                      lambda p: seen.append([it["path"] for it in p.batch_items]))
    got = pred(list(frames), batch=3)
    assert [len(s) for s in seen] == [3, 3, 2]
    assert sum(seen, []) == [f"array{i}.jpg" for i in range(FRAMES)] == [r.path for r in got]
    assert list(pred.trackers) == ["__frames__"]
    assert _same_track_results(got, single) >= FRAMES


def test_not_ported_gmc_methods_raise_through_track(frames, frame_dir, tmp_path, caplog):
    """The `orb` and `sift` GMC, once refused, now track: `YOLO.track` with
    a BoT-SORT YAML naming each matches JAX's facade frame by frame, and
    `yolo track` runs with the `orb` one."""
    caplog.set_level(logging.INFO)
    y = port_model.YOLO(NPZ, device="cpu")
    with pytest.MonkeyPatch.context() as mp:  # JAX's predictor may save into runs/
        mp.chdir(tmp_path)
        jax_y = jax_model.YOLO(str(NPZ))
        for method in ("orb", "sift"):
            cfg = tmp_path / f"{method}.yaml"
            cfg.write_text(PTR.check_tracker_yaml("botsort.yaml").read_text().replace(
                "gmc_method: sparseOptFlow", f"gmc_method: {method}"))
            got = y.track(list(frames[:4]), imgsz=GMC_IMGSZ, tracker=str(cfg))
            assert y.predictor.trackers["__frames__"].gmc.method == method
            want = jax_y.track(list(frames[:4]), imgsz=GMC_IMGSZ, tracker=str(cfg))
            assert _same_track_results(got, want) >= 8  # two objects tracked over 4 frames
    out = port_cfg.entrypoint(["track", f"model={NPZ}", f"source={frame_dir}",
                               f"tracker={tmp_path / 'orb.yaml'}", f"imgsz={GMC_IMGSZ}",
                               "device=cpu"])
    assert len(out) == FRAMES and f"{out[-1].path}: " in caplog.text


TRACK_CASES = [
    ["track", "model=weights/x.npz", "source=frames/", "tracker=bytetrack.yaml", "conf=0.3"],
    ["detect", "track", "source=a.png", "tracker=botsort.yaml", "batch=4", "imgsz=320"],
    ["track", "model=yolov8n.yaml"],
]


@pytest.mark.parametrize("args", TRACK_CASES, ids=[" ".join(a) for a in TRACK_CASES])
def test_yolo_track_parses_as_jax(args, monkeypatch):
    _same_calls(_run(port_cfg, port_model, args, monkeypatch),
                _run(jax_cfg, jax_model, args, monkeypatch))


def test_yolo_track_runs_the_facade(frame_dir, jax_tracks, caplog):
    caplog.set_level(logging.INFO)
    out = port_cfg.entrypoint(["track", f"model={NPZ}", f"source={frame_dir}",
                               "tracker=bytetrack.yaml", f"imgsz={TRACK_IMGSZ}", "device=cpu"])
    assert _same_track_results(out, jax_tracks[1]) >= FRAMES
    ids = out[-1].boxes.id.astype(int).tolist()
    assert f"{out[-1].path}: {len(ids)} tracks {ids}" in caplog.text  # one line a frame
