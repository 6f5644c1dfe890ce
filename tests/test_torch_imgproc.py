"""The port's cv2-free 8-bit primitives (`data/imgproc.py`) against cv2 on
the CPU, on seeded images and colours (at most 2^16 colours per sweep).

Tolerances, each from what cv2 5.0 computes:

* `rotation_matrix_2d`, `bgr_to_hsv`, `lut`, `box_blur`, `median_blur`,
  `rgb_to_gray`, `gray_to_bgr`, `clahe`: bit for bit (the same integer or
  float32 arithmetic as cv2's);
* `warp_affine`, `warp_perspective`: bit for bit where the output width is
  a multiple of 64 (every pixel in cv2's vector code); elsewhere at most
  one grey level in at most 0.1% of the values, since cv2 computes the
  last (width mod 16) pixels of a row in scalar code, whose coordinates
  round differently near a .5 tie;
* `hsv_to_bgr`: bit for bit at a width that is a multiple of 32 (cv2's
  vector step; the pipeline's squares always are); elsewhere at most one
  level, and only in the last (width mod 32) columns, which cv2 computes
  in scalar code that rounds where the vector code truncates;
* the C++ hot loops (`native/src/host_augment.cpp`: the warps' sampling,
  `hsv_luts`, `median_blur`), which the functions above run by default,
  against their numpy versions (`plain=True`): bit for bit, on random
  shapes, matrices, borders and LUTs;
* `rgb_to_lab`: at most one level in at most 0.1% of the values, and
  `lab_to_rgb` at most two levels in at most 10%: cv2 builds its 8-bit LAB
  tables with its own soft-float library, which the port's double
  precision tables do not follow in every entry. Both are reached only by
  Albumentations' CLAHE branch (p=0.01).
"""
import math

import cv2
import numpy as np
import pytest

from mgdt_yolo_tpu_torch.data import imgproc
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

BORDER = (114, 114, 114)


def _held(got, want, what, max_diff=0, share=0.0, cols=None):
    """|got - want| <= max_diff, in at most `share` of the values, and
    (where `cols` is given) only in the columns from `cols` on."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, what
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    frac = float((d > 0).mean())
    print(f"{what}: max {d.max()}, differing {frac:.2e}")
    assert d.max() <= max_diff and frac <= share, (what, int(d.max()), frac)
    if cols is not None:
        assert not d[:, :cols].any(), what


def _colours(n=1 << 16, seed=0):
    """`n` seeded BGR triples with the greys, the corners of the cube and
    the primaries among them, as an (n // 256, 256, 3) image."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    g = np.arange(256, dtype=np.uint8)
    c[:256] = g[:, None]
    c[256:264] = [[b, gg, r] for b in (0, 255) for gg in (0, 255) for r in (0, 255)]
    c[264:264 + 256, 0] = g          # a ramp in each channel alone
    c[264:264 + 256, 1:] = 0
    return c.reshape(-1, 256, 3)


@pytest.mark.parametrize("center", [(0, 0), (3.3, 7.1), (320, 240)])
def test_rotation_matrix_bit_for_bit(center):
    rng = np.random.default_rng(1)
    for _ in range(50):
        a, s = rng.uniform(-180, 180), rng.uniform(0.1, 2.0)
        np.testing.assert_array_equal(imgproc.rotation_matrix_2d(center, a, s),
                                      cv2.getRotationMatrix2D(center, a, s))


def _matrix(rng, h, w, perspective):
    C = np.eye(3)
    C[:2, 2] = -w / 2, -h / 2
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D((0, 0), rng.uniform(-40, 40), rng.uniform(0.5, 1.5))
    S = np.eye(3)
    S[0, 1], S[1, 0] = (math.tan(rng.uniform(-8, 8) * math.pi / 180) for _ in range(2))
    P = np.eye(3)
    if perspective:
        P[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
    T = np.eye(3)
    T[:2, 2] = rng.uniform(0.4, 0.6) * w, rng.uniform(0.4, 0.6) * h
    return T @ S @ R @ P @ C


# (source h, w), output (w, h)
WARP_CASES = [((96, 128), (128, 96)), ((128, 128), (64, 64)), ((160, 320), (128, 128)),
              ((77, 93), (93, 77)), ((50, 210), (150, 60))]


@pytest.mark.parametrize("perspective", [False, True], ids=["affine", "perspective"])
@pytest.mark.parametrize("src,dsize", WARP_CASES, ids=[f"{s[1]}x{s[0]}-{d[0]}x{d[1]}"
                                                      for s, d in WARP_CASES])
def test_warps_against_cv2(src, dsize, perspective):
    rng = np.random.default_rng(src[0] * 7 + dsize[0] + perspective)
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    for k in range(3):
        M = _matrix(rng, *src, perspective)
        if perspective:
            got = imgproc.warp_perspective(img, M, dsize, BORDER)
            want = cv2.warpPerspective(img, M, dsize=dsize, borderValue=BORDER)
        else:
            got = imgproc.warp_affine(img, M[:2], dsize, BORDER)
            want = cv2.warpAffine(img, M[:2], dsize=dsize, borderValue=BORDER)
        exact = dsize[0] % 64 == 0
        _held(got, want, f"{dsize} {k}", 0 if exact else 1, 0.0 if exact else 1e-3)
    # one channel, the border's first value
    M = _matrix(rng, *src, False)
    _held(imgproc.warp_affine(img[..., 0], M[:2], dsize, BORDER),
          cv2.warpAffine(img[..., 0], M[:2], dsize=dsize, borderValue=BORDER),
          "one channel", 0 if dsize[0] % 64 == 0 else 1, 0.0 if dsize[0] % 64 == 0 else 1e-3)


def test_hsv_round_trip_against_cv2():
    c = _colours()
    hsv = imgproc.bgr_to_hsv(c)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(c, cv2.COLOR_BGR2HSV))
    # every HSV triple cv2's hue range gives, sampled: H 0-179
    rng = np.random.default_rng(2)
    t = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    t[..., 0] %= 180
    t[0, :180, 0], t[1, :, 1], t[2, :, 2] = np.arange(180), 0, np.arange(256)
    for img in (hsv, t):
        np.testing.assert_array_equal(imgproc.hsv_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_HSV2BGR))
    ragged = t[:, :250]
    _held(imgproc.hsv_to_bgr(ragged), cv2.cvtColor(np.ascontiguousarray(ragged),
                                                   cv2.COLOR_HSV2BGR),
          "ragged", 1, 1.0, cols=250 - 250 % 32)


def test_lut_and_gray_against_cv2():
    c = _colours(seed=3)
    table = np.random.default_rng(3).integers(0, 256, 256, dtype=np.uint8)
    np.testing.assert_array_equal(imgproc.lut(c, table), cv2.LUT(c, table))
    g = imgproc.rgb_to_gray(c)
    np.testing.assert_array_equal(g, cv2.cvtColor(c, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(imgproc.gray_to_bgr(g), cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))


def test_lab_against_cv2():
    c = _colours(seed=4)
    lab = imgproc.rgb_to_lab(c)
    _held(lab, cv2.cvtColor(c, cv2.COLOR_RGB2LAB), "rgb_to_lab", 1, 1e-3)
    _held(imgproc.lab_to_rgb(lab), cv2.cvtColor(lab, cv2.COLOR_LAB2RGB), "lab_to_rgb", 2, 0.1)


FILTER_SHAPES = [(64, 64), (37, 53), (101, 77)]


@pytest.mark.parametrize("hw", FILTER_SHAPES, ids=[f"{w}x{h}" for h, w in FILTER_SHAPES])
def test_blur_and_median_against_cv2(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    for k in (3, 5, 7):
        np.testing.assert_array_equal(imgproc.box_blur(img, k), cv2.blur(img, (k, k)))
        np.testing.assert_array_equal(imgproc.median_blur(img, k), cv2.medianBlur(img, k))
    with pytest.raises(ValueError, match="3, 5 or 7"):
        imgproc.median_blur(img, 9)


CLAHE_SHAPES = [(64, 64), (128, 96), (100, 76), (64, 76), (37, 53)]


@pytest.mark.parametrize("hw", CLAHE_SHAPES, ids=[f"{w}x{h}" for h, w in CLAHE_SHAPES])
def test_clahe_against_cv2(hw):
    rng = np.random.default_rng(hw[1])
    # a low-contrast ramp with noise: the clip limit bites
    img = (rng.integers(0, 64, hw) + np.arange(hw[1])[None] % 96).astype(np.uint8)
    for clip in (1.0, 2.5, 4.0):
        want = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(img)
        np.testing.assert_array_equal(imgproc.clahe(img, clip, (8, 8)), want, err_msg=str(clip))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cpp_hot_loops_match_numpy_bit_for_bit(seed):
    """The C++ sampling (affine and perspective, three channels and one,
    outputs larger and smaller than the source, taps far outside), HSV
    LUTs and median filter against the numpy functions."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(8, 160, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        M = np.eye(3)
        M[:2] = cv2.getRotationMatrix2D((0, 0), rng.uniform(-90, 90), rng.uniform(0.2, 3.0))
        M[:2, 2] = rng.uniform(-w, 2 * w), rng.uniform(-h, 2 * h)
        M[2, :2] = rng.uniform(-3e-3, 3e-3, 2)
        dsize = tuple(int(v) for v in rng.integers(4, 200, 2))
        border = tuple(int(v) for v in rng.integers(0, 256, 3))
        for one in (img, img[..., 1]):
            np.testing.assert_array_equal(
                imgproc.warp_affine(one, M[:2], dsize, border),
                imgproc.warp_affine(one, M[:2], dsize, border, plain=True))
            np.testing.assert_array_equal(
                imgproc.warp_perspective(one, M, dsize, border),
                imgproc.warp_perspective(one, M, dsize, border, plain=True))
        luts = [rng.integers(0, 256, 256, dtype=np.uint8) for _ in range(3)]
        luts[0] %= 180
        np.testing.assert_array_equal(imgproc.hsv_luts(img, *luts),
                                      imgproc.hsv_luts(img, *luts, plain=True))
        for k in (3, 5, 7):
            np.testing.assert_array_equal(imgproc.median_blur(img, k),
                                          imgproc.median_blur(img, k, plain=True))
