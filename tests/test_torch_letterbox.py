"""The port's cv2-free letterbox (`data/augment.py`) against the JAX
package's, which resizes with `cv2.resize(..., INTER_LINEAR)` (CPU).

Seeded uint8 images of many shapes: the same size, integer down-ratios
(3x, and 2x, where cv2 takes its INTER_AREA fast path), non-integer up- and
down-ratios, odd, tall and wide sizes, and each branch (`scaleup=False`,
`auto`, `scale_fill`). Tolerances:

* `ratio` and the pads: exact (the same Python arithmetic);
* pixels: exact where the ratio is 1 or the source an integer multiple of
  the output (every tap weight is 0, 1 or a half); elsewhere at most one
  grey level in at most 0.5% of the values, since cv2 rounds the last few
  values of a row in scalar code, whose rounding may differ from its vector
  code's by one level (on this box's cv2 every case is exact, and the
  share is printed under `-s`).
"""
import cv2
import numpy as np
import pytest

from mgdt_yolo_tpu.data.augment import letterbox as jax_letterbox
from mgdt_yolo_tpu_torch.data.augment import letterbox, resize_linear
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHARE_LIMIT = 0.005

# (source h, w), new shape, letterbox keywords, whether cv2's bits are owed
CASES = [
    ((64, 64), 64, {}, True),                          # same size
    ((480, 640), (480, 640), {}, True),                # same size, not square
    ((1080, 1920), 640, {}, True),                     # 3x down (a camera frame)
    ((720, 1280), 640, {}, True),                      # 2x down: cv2's INTER_AREA path
    ((128, 96), 64, {}, True),                         # 2x down, padded
    ((300, 500), 640, {}, False),                      # non-integer up
    ((375, 500), 640, {}, False),                      # non-integer up (a photo)
    ((50, 40), 96, {}, False),                         # non-integer up, small
    ((1000, 750), 640, {}, False),                     # non-integer down
    ((97, 131), 64, {}, False),                        # odd, down
    ((33, 65), 96, {}, False),                         # odd, up
    ((200, 90), 128, {}, False),                       # tall
    ((45, 190), 128, {}, False),                       # wide
    ((50, 40), 96, {"scaleup": False}, True),          # no enlarging: pad only
    ((97, 131), 64, {"scaleup": False}, False),        # no enlarging, still shrinks
    ((300, 500), 640, {"auto": True}, False),          # pad to a stride multiple
    ((300, 500), 640, {"scale_fill": True}, False),    # stretch, two ratios
    ((160, 120), (80, 60), {"scale_fill": True}, True),  # stretch at 2x down
]


def _held(got, want, exact, what):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((d > 0).mean())
    print(f"{what}: differing {share:.4%}, max {d.max()}")
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert d.max() <= 1 and share <= SHARE_LIMIT, (what, d.max(), share)


@pytest.mark.parametrize("hw,new_shape,kw,exact", CASES,
                         ids=[f"{h}x{w}-{s}-{'-'.join(k) or 'plain'}"
                              for (h, w), s, k, _ in CASES])
def test_letterbox_matches_jax(hw, new_shape, kw, exact):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, ratio, pad = letterbox(img, new_shape, **kw)
    want, want_ratio, want_pad = jax_letterbox(img, new_shape, **kw)
    assert ratio == want_ratio and pad == want_pad
    _held(got, want, exact, f"{hw} -> {new_shape} {kw}")


@pytest.mark.parametrize("seed", range(4))
def test_resize_matches_cv2_on_random_shapes(seed):
    """`resize_linear` against `cv2.resize` itself, 8 random size pairs a
    seed, sources and outputs from 1 to 400 pixels a side."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(8):
        (h, w), (dh, dw) = rng.integers(1, 401, (2, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (int(dw), int(dh)), interpolation=cv2.INTER_LINEAR)
        exact = h % dh == 0 and w % dw == 0
        _held(resize_linear(img, (int(dw), int(dh))), want, exact, f"{(h, w)} -> {(dh, dw)}")


def test_resize_takes_views_and_keeps_the_source():
    """A BGR->RGB view (negative strides) resizes as its copy does."""
    img = np.random.default_rng(7).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    view = img[..., ::-1]
    np.testing.assert_array_equal(resize_linear(view, (64, 48)),
                                  resize_linear(np.ascontiguousarray(view), (64, 48)))
