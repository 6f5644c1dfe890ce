"""The camera's frame-to-frame motion for BoT-SORT, without cv2: the
counterpart of the JAX package's `mgdt_yolo_tpu/tracker/gmc.py`.

`GMC(method, downscale=2).apply(img)` returns the (2, 3) float64 affine
map H that takes the previous frame's coordinates to this frame's, on the
frames' gray images downscaled by `downscale` (`_prep`: cv2's BGR to gray
weights, then cv2's INTER_LINEAR resize to (W // downscale, H //
downscale)), with its translation scaled back to full resolution. The
first frame returns the identity; every call stores its frame.

Methods, the JAX GMC's cv2 calls computed by `native/src/host_gmc.cpp` and
`native/src/host_features.cpp` (built by g++ at first use) by cv2's own
arithmetic:

* `sparseOptFlow` (the default): Shi-Tomasi corners of the previous frame
  (`good_features`: goodFeaturesToTrack, 1000 corners, quality 0.01,
  distance 1, block 3), tracked into this frame by pyramidal Lucas-Kanade
  (`optical_flow`: calcOpticalFlowPyrLK at cv2's defaults), and the
  partial affine (rotation, uniform scale, translation) of the tracked
  pairs (`affine_partial`: estimateAffinePartial2D by RANSAC with cv2's
  seeded generator, then Levenberg-Marquardt on the inliers). The corners
  are found again on the previous frame when fewer than 4 are left.
* `ecc`: the Euclidean map maximising the enhanced correlation coefficient
  (`ecc`: findTransformECC, 100 iterations or a change under 1e-5, the 5 x
  5 Gaussian pre-filter); where cv2 raises (a NaN correlation, or a step
  that would lower it), H stays the identity, as JAX's `except cv2.error`
  leaves it.
* `orb`: ORB features of the previous and this frame (`orb_features`:
  ORB_create().detectAndCompute, 500 features over 8 levels of factor
  1.2, FAST threshold 20, Harris scores, the 256 rotated tests of cv2's
  point pairs), each of the previous frame's matched to its nearest in
  this frame by Hamming distance (`match`: BFMatcher(NORM_HAMMING).match),
  and the partial affine of the matched points (`affine_partial`). cv2's
  own bits: keypoints, descriptors and matches.
* `sift`: the same with SIFT features (`sift_features`: SIFT_create().
  detectAndCompute, 3 layers an octave on the doubled image) and L2
  matching (BFMatcher(NORM_L2)). The keypoints and their order are cv2's;
  positions, sizes and descriptors are those of cv2's AVX2/AVX-512 code
  bit for bit, the orientations within 1e-4 degrees (cv2 there calls
  IPP's exp, whose last bit the port does not follow). cv2's own two
  paths (`cv2.setUseOptimized(False)` against the default) lie up to 1e-2
  px apart on 1080p frames.
* `none` (or None): the identity.

For `orb` and `sift` each frame's features are computed once, for it and
for the next frame; fewer than 4 keypoints on either frame, or fewer than
4 matches, leave H the identity, as JAX's.
"""
from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from ..data.augment import resize_linear

METHODS = ("sparseOptFlow", "ecc", "orb", "sift", "none")
# cv2's defaults in the calls of JAX's GMC
MAX_CORNERS, QUALITY = 1000, 0.01  # and minDistance 1, blockSize 3
LK_WIN, LK_LEVELS, LK_ITERS, LK_EPS, LK_MIN_EIG = 21, 3, 30, 0.01, 1e-4
RANSAC_THRESH, RANSAC_ITERS, RANSAC_CONFIDENCE, REFINE_ITERS = 3.0, 2000, 0.99, 10
ECC_ITERS, ECC_EPS = 100, 1e-5


def cpu_threads() -> int:
    """The CPUs this process may run on (its affinity, which a container's
    limit sets), where the machine's own count can be far off."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity on this platform
        return os.cpu_count() or 1


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load `native/src/host_gmc.cpp` with
    `host_features.cpp`, their loops on up to 8 of the process's CPUs."""
    from ..utils.build import HOST_GMC, load_library
    p, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib = load_library(HOST_GMC, (
        ("mgdt_gmc_set_threads", i32, (i32,)),
        ("mgdt_gmc_gray", None, (p, i32, i32, i32, p)),
        ("mgdt_gmc_min_eig", None, (p, i32, i32, p)),
        ("mgdt_gmc_corners", i32, (p, i32, i32, i32, f64, p)),
        ("mgdt_gmc_lk", None, (p, p, i32, i32, p, i32, i32, i32, i32, f64, f64, p, p)),
        ("mgdt_gmc_pyramid_level", i32, (p, i32, i32, i32, i32, p, p)),
        ("mgdt_gmc_affine_partial", i32, (p, p, i32, f64, i32, f64, i32, p, p)),
        ("mgdt_gmc_ecc", i32, (p, p, i32, i32, p, i32, f64)),
        ("mgdt_feat_orb", p, (p, i32, i32, i32)),
        ("mgdt_feat_sift", p, (p, i32, i32)),
        ("mgdt_feat_count", i32, (p,)),
        ("mgdt_feat_get", None, (p, p, p)),
        ("mgdt_feat_free", None, (p,)),
        ("mgdt_feat_match", None, (p, i32, p, i32, i32, p, p)),
        ("mgdt_feat_resize_exact", None, (p, i32, i32, p, i32, i32)),
        ("mgdt_feat_orb_blur", None, (p, i32, i32, p)),
        ("mgdt_feat_fast", i32, (p, i32, i32, i32, p, i32)),
        ("mgdt_feat_fast_atan2", ctypes.c_float, (ctypes.c_float, ctypes.c_float)),
        ("mgdt_feat_phase", None, (p, p, i32, p)),
        ("mgdt_feat_exp", None, (p, i32, p)),
        ("mgdt_feat_gauss_f32", None, (p, i32, i32, f64, p)),
        ("mgdt_feat_sift_base", None, (p, i32, i32, p)),
    ))
    lib.mgdt_gmc_set_threads(cpu_threads())
    return lib


def _gray(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"a gray (h, w) uint8 image is needed, got {img.shape} {img.dtype}")
    return np.ascontiguousarray(img)


def bgr_to_gray(img: np.ndarray, half: bool = False) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)` (cv2's 15-bit weights) of a
    (h, w, 3) uint8 image; with `half` (h and w even) then `cv2.resize` to
    (w // 2, h // 2), which cv2 computes as the rounded mean of each 2 x 2
    block."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"a BGR (h, w, 3) uint8 image is needed, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if half and (h % 2 or w % 2):
        raise ValueError(f"halving needs an even height and width, got {h} x {w}")
    src = np.ascontiguousarray(img)
    out = np.empty((h // 2, w // 2) if half else (h, w), np.uint8)
    _lib().mgdt_gmc_gray(src.ctypes.data, h, w, int(half), out.ctypes.data)
    return out


def min_eigen(gray: np.ndarray) -> np.ndarray:
    """`cv2.cornerMinEigenVal(gray, 3, ksize=3)`: (h, w) float32."""
    g = _gray(gray)
    out = np.empty(g.shape, np.float32)
    _lib().mgdt_gmc_min_eig(g.ctypes.data, g.shape[0], g.shape[1], out.ctypes.data)
    return out


def good_features(gray: np.ndarray) -> Optional[np.ndarray]:
    """`cv2.goodFeaturesToTrack(gray, maxCorners=1000, qualityLevel=0.01,
    minDistance=1, blockSize=3)`: (n, 1, 2) float32 corners, or None where
    there are none."""
    g = _gray(gray)
    xy = np.empty((MAX_CORNERS, 2), np.float32)
    n = _lib().mgdt_gmc_corners(g.ctypes.data, g.shape[0], g.shape[1], MAX_CORNERS, QUALITY,
                                xy.ctypes.data)
    return xy[:n].reshape(-1, 1, 2).copy() if n else None


def optical_flow(prev: np.ndarray, frame: np.ndarray, pts: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """`cv2.calcOpticalFlowPyrLK(prev, frame, pts, None)` at cv2's defaults:
    (next points (n, 1, 2) float32, status (n, 1) uint8)."""
    a, b = _gray(prev), _gray(frame)
    if a.shape != b.shape:
        raise ValueError(f"the frames differ in size: {a.shape} and {b.shape}")
    p = np.ascontiguousarray(np.asarray(pts, np.float32).reshape(-1, 2))
    nxt = np.empty_like(p)
    status = np.empty(len(p), np.uint8)
    _lib().mgdt_gmc_lk(a.ctypes.data, b.ctypes.data, a.shape[0], a.shape[1], p.ctypes.data,
                       len(p), LK_WIN, LK_LEVELS, LK_ITERS, LK_EPS, LK_MIN_EIG,
                       nxt.ctypes.data, status.ctypes.data)
    return nxt.reshape(-1, 1, 2), status.reshape(-1, 1)


def affine_partial(src: np.ndarray, dst: np.ndarray
                   ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """`cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)`: (M (2, 3)
    float64 or None, inlier mask (n, 1) uint8)."""
    a = np.ascontiguousarray(np.asarray(src, np.float32).reshape(-1, 2))
    b = np.ascontiguousarray(np.asarray(dst, np.float32).reshape(-1, 2))
    if len(a) != len(b):
        raise ValueError(f"{len(a)} source points and {len(b)} destination points")
    M = np.zeros((2, 3))
    mask = np.zeros(len(a), np.uint8)
    ok = _lib().mgdt_gmc_affine_partial(a.ctypes.data, b.ctypes.data, len(a), RANSAC_THRESH,
                                        RANSAC_ITERS, RANSAC_CONFIDENCE, REFINE_ITERS,
                                        M.ctypes.data, mask.ctypes.data)
    return (M if ok else None), mask.reshape(-1, 1)


def ecc(template: np.ndarray, frame: np.ndarray) -> Optional[np.ndarray]:
    """`cv2.findTransformECC(template, frame, eye(2, 3), MOTION_EUCLIDEAN,
    (EPS | COUNT, 100, 1e-5))`'s map (2, 3) float32, or None where cv2
    raises."""
    a, b = _gray(template), _gray(frame)
    if a.shape != b.shape:
        raise ValueError(f"the frames differ in size: {a.shape} and {b.shape}")
    warp = np.eye(2, 3, dtype=np.float32)
    failed = _lib().mgdt_gmc_ecc(a.ctypes.data, b.ctypes.data, a.shape[0], a.shape[1],
                                 warp.ctypes.data, ECC_ITERS, ECC_EPS)
    return None if failed else warp


ORB_FEATURES = 500  # ORB_create()'s nfeatures
ORB_DESC, SIFT_DESC = (32, np.uint8), (128, np.float32)
# the matcher's norm by descriptor: 0 Hamming (ORB), 1 L2 (SIFT)
NORMS = {(ORB_DESC[0], np.dtype(ORB_DESC[1])): 0, (SIFT_DESC[0], np.dtype(SIFT_DESC[1])): 1}


def _features(handle, desc) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    lib = _lib()
    try:
        n = lib.mgdt_feat_count(handle)
        kps = np.empty((n, 7), np.float64)
        d = np.empty((n, desc[0]), desc[1])
        lib.mgdt_feat_get(handle, kps.ctypes.data, d.ctypes.data)
    finally:
        lib.mgdt_feat_free(handle)
    return kps, (d if n else None)


def orb_features(gray: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """`cv2.ORB_create().detectAndCompute(gray, None)`: keypoints (n, 7)
    float64 (x, y, size, angle, response, octave, class_id) in cv2's order,
    and descriptors (n, 32) uint8, None where there are no keypoints."""
    g = _gray(gray)
    return _features(_lib().mgdt_feat_orb(g.ctypes.data, g.shape[0], g.shape[1], ORB_FEATURES),
                     ORB_DESC)


def sift_features(gray: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """`cv2.SIFT_create().detectAndCompute(gray, None)`: keypoints (n, 7)
    float64 as `orb_features`' (the octave word packs octave, layer and
    sub-layer as cv2's) in cv2's order, and descriptors (n, 128) float32,
    None where there are no keypoints."""
    g = _gray(gray)
    return _features(_lib().mgdt_feat_sift(g.ctypes.data, g.shape[0], g.shape[1]), SIFT_DESC)


def match(query: np.ndarray, train: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`cv2.BFMatcher(norm).match(query, train)`, NORM_HAMMING for uint8
    (n, 32) descriptors and NORM_L2 for float32 (n, 128): (queryIdx,
    trainIdx, distance) of the nearest train row of every query row, in
    query order, the lowest index among equals; none without train rows."""
    q, t = np.ascontiguousarray(query), np.ascontiguousarray(train)
    kind = NORMS.get((q.shape[-1], q.dtype)) if q.ndim == 2 else None
    if kind is None or t.ndim != 2 or (t.shape[1], t.dtype) != (q.shape[1], q.dtype):
        raise ValueError(f"ORB (n, 32) uint8 or SIFT (n, 128) float32 descriptors are needed, "
                         f"got {q.shape} {q.dtype} and {t.shape} {t.dtype}")
    n = len(q) if len(t) else 0
    idx, dist = np.empty(n, np.int32), np.empty(n, np.float32)
    if n:
        _lib().mgdt_feat_match(q.ctypes.data, n, t.ctypes.data, len(t), kind,
                               idx.ctypes.data, dist.ctypes.data)
    return np.arange(n, dtype=np.int32), idx, dist


class GMC:
    """The camera-motion estimator of one stream; see the module's text."""

    def __init__(self, method: Optional[str] = "sparseOptFlow", downscale: int = 2):
        if method not in (*METHODS, None):
            raise ValueError(f"unknown gmc_method {method!r}; choose from {', '.join(METHODS)}")
        self.method = method
        self.downscale = max(1, downscale)
        self.prev_frame = None
        self.prev_kpts = None
        self.prev_features = None  # orb / sift: the stored frame's (keypoints, descriptors)
        self.initialized = False

    def _features(self, gray: np.ndarray):
        return (orb_features if self.method == "orb" else sift_features)(gray)

    def _prep(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        d = self.downscale
        if img.ndim == 3 and d == 2 and h % 2 == 0 and w % 2 == 0:
            return bgr_to_gray(img, half=True)  # both steps in one pass
        gray = bgr_to_gray(img) if img.ndim == 3 else img
        if d > 1:
            gray = resize_linear(gray[..., None], (w // d, h // d))[..., 0]
        return np.ascontiguousarray(gray)

    def apply(self, img: np.ndarray) -> np.ndarray:
        H = np.eye(2, 3)
        if self.method in (None, "none"):
            return H
        frame = self._prep(img)
        if not self.initialized:
            self.prev_frame = frame.copy()
            if self.method == "sparseOptFlow":
                self.prev_kpts = good_features(frame)
            elif self.method in ("orb", "sift"):
                self.prev_features = self._features(frame)
            self.initialized = True
            return H
        if self.method == "sparseOptFlow":
            if self.prev_kpts is None or len(self.prev_kpts) < 4:
                self.prev_kpts = good_features(self.prev_frame)
            if self.prev_kpts is not None and len(self.prev_kpts) >= 4:
                nxt, status = optical_flow(self.prev_frame, frame, self.prev_kpts)
                ok = status.ravel() == 1
                if ok.sum() >= 4:
                    M, _ = affine_partial(self.prev_kpts[ok], nxt[ok])
                    if M is not None:
                        H = M
            self.prev_kpts = good_features(frame)
        elif self.method in ("orb", "sift"):
            (k1, d1), (k2, d2) = self.prev_features, self._features(frame)
            self.prev_features = (k2, d2)
            if d1 is not None and d2 is not None and len(k1) >= 4 and len(k2) >= 4:
                q, t, _ = match(d1, d2)
                if len(q) >= 4:
                    M, _ = affine_partial(k1[q, :2].astype(np.float32),
                                          k2[t, :2].astype(np.float32))
                    if M is not None:
                        H = M
        else:  # ecc
            warp = ecc(self.prev_frame, frame)
            if warp is not None:
                H = warp
        self.prev_frame = frame.copy()
        H = np.asarray(H, np.float64)
        H[0, 2] *= self.downscale
        H[1, 2] *= self.downscale
        return H
