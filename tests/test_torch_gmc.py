"""The trackers' camera-motion compensation (`tracker/gmc.py`, C++ in
`native/src/host_gmc.cpp`) against cv2 on the CPU, part by part, and the
whole `GMC` against the JAX package's (which calls cv2). Inputs are the
port's seeded synthetic scenes, cut by `imgproc.warp_affine` under an
integer shift, a sub-pixel shift and a small rotation. Limits, each with
its reason:

* `_prep` (gray, then the half-size resize), the minimum-eigenvalue map,
  the corners, the pyramid and its Scharr derivatives: bit for bit. The
  corners' order among equal values is cv2's (the later pixel first), so
  even a cut at the 1000th corner inside a run of ties gives cv2's set;
* the Lucas-Kanade points: within 0.01 px (bit for bit seen), the status
  equal;
* the RANSAC inlier mask: equal (cv2's generator and draws); H within
  1e-4: the port runs Levenberg-Marquardt to the inliers' least-squares
  optimum, cv2's solver stops up to ~2e-6 short of it;
* ECC's map: within 1e-4 (1e-5 seen): the same iteration in float32, the
  sums in double where cv2 sums blocks of floats;
* the whole `GMC` over 16 panning frames at 1080 x 1920: the translation
  within 0.05 px at full resolution, the 2 x 2 part within 5e-4 (ECC
  that runs all 100 iterations without converging stays ~4e-3 px of cv2);
* the default BoT-SORT over those frames, with the scene's boxes moved by
  the pan as detections: IDs equal to JAX's, boxes within 0.1 px.
"""
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from mgdt_yolo_tpu.tracker.bot_sort import BOTSORT as JaxBOTSORT
from mgdt_yolo_tpu.tracker.gmc import GMC as JaxGMC
from mgdt_yolo_tpu_torch.data import imgproc
from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence, synthetic_scene
from mgdt_yolo_tpu_torch.tracker import gmc as G
from mgdt_yolo_tpu_torch.tracker.bot_sort import BOTSORT
from mgdt_yolo_tpu_torch.utils import build
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

PAN_FRAMES = 16
ECC_CRITERIA = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 1e-5)


def _gray_scene(h, w, seed=0):
    return cv2.cvtColor(synthetic_scene(seed, max(h, w) + 40)[:h, :w], cv2.COLOR_BGR2GRAY)


def _pair(h, w, motion, seed=0):
    """(prev, next) gray frames of one scene: next is prev moved by
    `motion`: ("shift", dx, dy) or ("rotate", degrees)."""
    s = max(h, w) + 40
    scene = synthetic_scene(seed, s)
    prev = scene[20:20 + h, 20:20 + w]
    if motion[0] == "shift":
        M = np.array([[1.0, 0.0, motion[1] - 20], [0.0, 1.0, motion[2] - 20]])
    else:
        M = imgproc.rotation_matrix_2d((20 + w / 2, 20 + h / 2), motion[1], 1.0)
        M[:, 2] -= 20
    nxt = imgproc.warp_affine(scene, M, (w, h))
    gray = lambda im: cv2.cvtColor(np.ascontiguousarray(im), cv2.COLOR_BGR2GRAY)  # noqa: E731
    return gray(prev), gray(nxt)


MOTIONS = [("shift", 6.0, -4.0), ("shift", 2.5, 1.25), ("rotate", 1.5)]


@pytest.mark.parametrize("shape", [(1080, 1920), (121, 163), (96, 128)])
@pytest.mark.parametrize("downscale", [1, 2, 3])
def test_prep_is_cv2_bit_for_bit(shape, downscale):
    img = synthetic_scene(1, max(shape))[:shape[0], :shape[1]]
    got = G.GMC("sparseOptFlow", downscale=downscale)._prep(img)
    want = JaxGMC("sparseOptFlow", downscale=downscale)._prep(img)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)  # a gray frame is taken as it is
    np.testing.assert_array_equal(G.GMC("ecc", downscale=downscale)._prep(gray),
                                  JaxGMC("ecc", downscale=downscale)._prep(gray))


@pytest.mark.parametrize("shape", [(540, 960), (67, 101), (60, 140), (33, 47)])
def test_min_eigenvalue_and_corners_are_cv2s(shape):
    gray = _gray_scene(*shape, seed=2)
    np.testing.assert_array_equal(G.min_eigen(gray), cv2.cornerMinEigenVal(gray, 3, ksize=3))
    want = cv2.goodFeaturesToTrack(gray, maxCorners=1000, qualityLevel=0.01, minDistance=1,
                                   blockSize=3)
    got = G.good_features(gray)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_corner_ties_and_a_flat_frame():
    """A tiled texture has a few distinct eigenvalues over thousands of
    maxima: the 1000 taken, cut inside a run of ties, are cv2's; a flat
    frame has no corner."""
    tile = np.random.default_rng(0).integers(0, 256, (8, 8), dtype=np.uint8)
    img = np.ascontiguousarray(np.tile(tile, (38, 59))[:300, :470])
    want = cv2.goodFeaturesToTrack(img, 1000, 0.01, 1, blockSize=3)
    np.testing.assert_array_equal(G.good_features(img), want)
    eig = cv2.cornerMinEigenVal(img, 3, ksize=3)
    taken = G.good_features(img).reshape(-1, 2).astype(int)
    assert len(np.unique(eig[taken[:, 1], taken[:, 0]])) < 10
    flat = np.full((60, 80), 100, np.uint8)
    assert G.good_features(flat) is None and cv2.goodFeaturesToTrack(flat, 1000, 0.01, 1) is None


@pytest.mark.parametrize("shape", [(540, 960), (75, 99), (120, 160)])
def test_pyramid_and_scharr_derivatives_are_cv2s(shape):
    gray = _gray_scene(*shape, seed=3)
    levels, pyr = cv2.buildOpticalFlowPyramid(gray, (21, 21), 3, withDerivatives=True)
    lib = G._lib()
    for lev in range(levels + 1):
        want, dwant = pyr[2 * lev], pyr[2 * lev + 1]
        h, w = want.shape[:2]
        out, der = np.empty((h, w), np.uint8), np.empty((h, w, 2), np.int16)
        assert lib.mgdt_gmc_pyramid_level(gray.ctypes.data, *shape, 21, lev, out.ctypes.data,
                                          der.ctypes.data) == 0
        np.testing.assert_array_equal(out, want.reshape(h, w))
        np.testing.assert_array_equal(der, dwant.reshape(h, w, 2))
    if levels < 3:  # the pyramid stops where cv2's does: its next level is no wider than the window
        out = np.empty(gray.shape, np.int16)
        assert lib.mgdt_gmc_pyramid_level(gray.ctypes.data, *shape, 21, levels + 1,
                                          out.ctypes.data, out.ctypes.data) == -1


@pytest.mark.parametrize("motion", MOTIONS, ids=["integer", "subpixel", "rotation"])
def test_lucas_kanade_and_ransac_match_cv2(motion):
    prev, nxt = _pair(540, 960, motion)
    pts = cv2.goodFeaturesToTrack(prev, 1000, 0.01, 1, blockSize=3)
    # points near and past the edges too, where the status rules decide
    edge = np.array([[[0.5, 0.5]], [[958.7, 3.2]], [[-15.0, 100.0]], [[970.0, 539.0]],
                     [[5.0, 545.0]]], np.float32)
    pts = np.concatenate([pts, edge])
    want, wstatus, _ = cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None)
    got, status = G.optical_flow(prev, nxt, pts)
    np.testing.assert_array_equal(status, wstatus)
    ok = wstatus.ravel() == 1
    assert ok.sum() > 900 and not ok.all()
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=0.01)
    M, inl = G.affine_partial(pts[ok], got[ok])
    Mw, inlw = cv2.estimateAffinePartial2D(pts[ok], want[ok], method=cv2.RANSAC)
    np.testing.assert_array_equal(inl, inlw)
    np.testing.assert_allclose(M, Mw, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [2, 4, 37, 300, 1000])
def test_ransac_on_outliers_matches_cv2(n):
    """Seeded pairs under a rotation and shift with noise and 30% outliers:
    cv2's subsets, so its inliers, and its refined map."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0, 900, (n, 2)).astype(np.float32)
    ang = rng.uniform(-0.05, 0.05)
    R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    b = (a @ R.T + rng.uniform(-10, 10, 2) + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    out = rng.random(n) < 0.3
    b[out] += rng.uniform(-50, 50, (out.sum(), 2)).astype(np.float32)
    M, inl = G.affine_partial(a, b)
    Mw, inlw = cv2.estimateAffinePartial2D(a, b, method=cv2.RANSAC)
    np.testing.assert_array_equal(inl, inlw)
    np.testing.assert_allclose(M, Mw, rtol=0, atol=1e-4)


@pytest.mark.parametrize("motion", MOTIONS[:2] + [("rotate", 1.0)],
                         ids=["integer", "subpixel", "rotation"])
def test_ecc_matches_cv2(motion):
    prev, nxt = _pair(240, 320, motion, seed=4)
    _, want = cv2.findTransformECC(prev, nxt, np.eye(2, 3, dtype=np.float32),
                                   cv2.MOTION_EUCLIDEAN, ECC_CRITERIA)
    got = G.ecc(prev, nxt)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_ecc_where_cv2_raises_gives_the_identity():
    """cv2 raises at the first iteration on a flat template (a NaN
    correlation) and on a negated frame (the step would lower the
    correlation): the port's `ecc` returns None and the GMC the identity,
    as JAX's. (On frames that do not correlate at all, ECC's iterations are
    chaotic: float32 rounding parts cv2's path and the port's within ~10
    iterations, and either may raise where the other does not; ROADMAP
    queue 3.)"""
    a = cv2.cvtColor(synthetic_scene(3, 160)[:120], cv2.COLOR_BGR2GRAY)
    for template, frame in ((np.full_like(a, 90), a), (a, 255 - a)):
        with pytest.raises(cv2.error):
            cv2.findTransformECC(template, frame, np.eye(2, 3, dtype=np.float32),
                                 cv2.MOTION_EUCLIDEAN, ECC_CRITERIA)
        assert G.ecc(template, frame) is None
        for gmc in (G.GMC("ecc", downscale=1), JaxGMC("ecc", downscale=1)):
            gmc.apply(template)
            np.testing.assert_array_equal(gmc.apply(frame), np.eye(2, 3))


def test_too_few_features_gives_the_identity_as_jax():
    """A flat frame has no corner: H stays the identity, and the corners are
    searched again on the stored frame at the next call, as JAX's."""
    flat = np.full((120, 160, 3), 90, np.uint8)
    scene = np.ascontiguousarray(synthetic_scene(5, 160)[:120])
    for frames in ([flat, flat, flat], [flat, scene, scene]):
        got, want = G.GMC(), JaxGMC()
        for f in frames:
            h, hw = got.apply(f), want.apply(f)
            np.testing.assert_allclose(h, hw, rtol=0, atol=1e-4)
        assert (got.prev_kpts is None) == (want.prev_kpts is None)
    np.testing.assert_array_equal(G.GMC().apply(flat), np.eye(2, 3))


def test_methods_not_ported_raise_and_none_is_the_identity():
    """Every method of JAX's GMC is ported (`orb` and `sift` are held in
    `tests/test_torch_gmc_features.py`); an unknown one raises, naming all
    five, and `none` is the identity."""
    with pytest.raises(ValueError, match="unknown gmc_method 'optflow'; choose from "
                                         "sparseOptFlow, ecc, orb, sift, none"):
        G.GMC("optflow")
    img = synthetic_scene(0, 64)
    for method in ("none", None):
        gmc = G.GMC(method)
        assert all(np.array_equal(gmc.apply(img), np.eye(2, 3)) for _ in range(2))
    for method in ("orb", "sift"):  # the first frame is the identity, as JAX's
        assert np.array_equal(G.GMC(method).apply(img), JaxGMC(method).apply(img))


@pytest.fixture(scope="module")
def pan():
    frames, offsets, item = panning_sequence(PAN_FRAMES)
    return frames, offsets, item


@pytest.mark.parametrize("method", ["sparseOptFlow", "ecc"])
def test_gmc_over_a_1080p_pan_matches_jax(pan, method):
    frames, offsets, _ = pan
    got, want = G.GMC(method), JaxGMC(method)
    for t, frame in enumerate(frames):
        h, hw = got.apply(frame), want.apply(frame)
        np.testing.assert_allclose(h[:, 2], hw[:, 2], rtol=0, atol=0.05, err_msg=f"frame {t}")
        np.testing.assert_allclose(h[:, :2], hw[:, :2], rtol=0, atol=5e-4, err_msg=f"frame {t}")
        if t:  # the content moves against the camera
            step = offsets[t] - offsets[t - 1]
            np.testing.assert_allclose(h[:, 2], -step, rtol=0, atol=0.1)


def test_default_botsort_over_the_pan_matches_jax(pan):
    """The scene's objects seen through the pan, jittered: BoT-SORT with its
    sparse-optical-flow GMC, frame by frame against JAX's."""
    frames, offsets, item = pan
    rng = np.random.default_rng(0)
    got, want = BOTSORT(), JaxBOTSORT()
    h, w = frames[0].shape[:2]
    for t, frame in enumerate(frames):
        boxes = item["boxes"] - np.tile(offsets[t], 2) + rng.normal(0, 0.5, item["boxes"].shape)
        boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
        seen = np.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]) > 16
        scores = rng.uniform(0.7, 0.95, len(boxes))[seen]
        boxes, cls = boxes[seen], item["cls"][seen]
        g = got.update(boxes, scores, cls, frame)
        wt = want.update(boxes, scores, cls, frame)
        assert g.shape == wt.shape, t
        np.testing.assert_array_equal(g[:, 4], wt[:, 4])
        np.testing.assert_allclose(g[:, :4], wt[:, :4], rtol=0, atol=0.1, err_msg=f"frame {t}")
        if t == 1:
            first = sorted(g[:, 4])
    # every object keeps its ID through the pan
    assert len(g) == seen.sum() >= 2 and sorted(g[:, 4]) == first


def test_threads_that_first_load_a_library_together_build_it_once(tmp_path, monkeypatch):
    """Several threads at a host library's first use (`panning_sequence`
    cuts its frames on four): one builds it, the others wait and load it;
    no thread's temporary file is moved under another's."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build.load_library.cache_clear()
    try:
        with ThreadPoolExecutor(4) as pool:
            libs = list(pool.map(lambda _: build.load_library(build.HOST_AUGMENT, ()), range(4)))
    finally:
        build.load_library.cache_clear()
    assert all(libs)
    assert len(list(tmp_path.glob("*.so"))) == 1 and not list(tmp_path.glob("*.tmp"))
