"""The port's resampling, anchor and DFL ops against the JAX package (CPU,
float32). The port's ops take NCHW maps; the JAX ones NHWC.

Tolerance 1e-6: both sides multiply by the same interpolation matrices (or
take the same max / softmax), and float32 rounding of the two contraction
orders differs by a few ulps of values of magnitude ~1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.data.dataset import SyntheticDetectionDataset
from mgdt_yolo_tpu.nn.modules.block import dfl_decode as jax_dfl
from mgdt_yolo_tpu.ops import boxes as jboxes
from mgdt_yolo_tpu.ops import common as jcommon
from mgdt_yolo_tpu_torch.data.synthetic import synthetic_batch, synthetic_scene
from mgdt_yolo_tpu_torch.nn.modules.block import dfl_decode
from mgdt_yolo_tpu_torch.ops import boxes, common

ATOL = 1e-6


def _map(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_nhwc(fn, x, *args):
    """Run an NCHW port op on an NHWC array, return NHWC numpy."""
    y = fn(torch.from_numpy(x).permute(0, 3, 1, 2), *args)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("in_hw,out_hw", [((16, 16), (8, 8)), ((16, 24), (4, 6)),
                                          ((20, 20), (6, 6)), ((13, 9), (5, 4)),
                                          ((16, 16), (2, 2)), ((7, 7), (1, 1))])
def test_adaptive_avg_pool(in_hw, out_hw):
    x = _map((2, *in_hw, 3))
    want = np.asarray(jcommon.adaptive_avg_pool2d(jnp.asarray(x), out_hw))
    got = _port_nhwc(common.adaptive_avg_pool2d, x, out_hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (8, 8)), ((5, 7), (20, 14)),
                                          ((16, 16), (6, 6)), ((1, 3), (4, 4))])
def test_bilinear(in_hw, out_hw):
    x = _map((2, *in_hw, 3), seed=1)
    want = np.asarray(jcommon.interpolate_bilinear(jnp.asarray(x), out_hw))
    got = _port_nhwc(common.interpolate_bilinear, x, out_hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bilinear_matches_torch_interpolate():
    """The rebuilt matrices agree with torch's own bilinear resize."""
    x = torch.from_numpy(_map((2, 3, 5, 7), seed=2))
    want = torch.nn.functional.interpolate(x, size=(20, 14), mode="bilinear",
                                           align_corners=False)
    torch.testing.assert_close(common.interpolate_bilinear(x, (20, 14)), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_max_pool_same(k):
    x = _map((2, 9, 11, 4), seed=3)
    want = np.asarray(jcommon.max_pool2d_same(jnp.asarray(x), k))
    got = _port_nhwc(common.max_pool2d_same, x, k)
    np.testing.assert_array_equal(got, want)


def test_h_sigmoid():
    x = _map((64,), seed=4) * 5
    want = np.asarray(jcommon.h_sigmoid(jnp.asarray(x)))
    np.testing.assert_allclose(common.h_sigmoid(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=ATOL)


def test_make_anchors_and_dist2bbox():
    shapes, strides = [(4, 6), (2, 3)], [8, 16]
    ja, js = jboxes.make_anchors(shapes, strides, 0.5)
    pa, ps = boxes.make_anchors(shapes, strides, 0.5)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    dist = np.abs(_map((2, pa.shape[0], 4), seed=5)) * 3
    for xywh in (True, False):
        want = np.asarray(jboxes.dist2bbox(jnp.asarray(dist), ja[None], xywh=xywh))
        got = boxes.dist2bbox(torch.from_numpy(dist), pa[None], xywh=xywh).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    xywh = np.abs(_map((10, 4), seed=6)) * 20
    np.testing.assert_allclose(boxes.xywh2xyxy(torch.from_numpy(xywh)).numpy(),
                               np.asarray(jboxes.xywh2xyxy(jnp.asarray(xywh))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("reg_max", [4, 16])
def test_dfl_decode(reg_max):
    box = _map((2, 50, 4 * reg_max), seed=7) * 3
    want = np.asarray(jax_dfl(jnp.asarray(box), reg_max))
    got = dfl_decode(torch.from_numpy(box), reg_max).numpy()
    # expectations over reg_max bins: values up to reg_max - 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_synthetic_scenes_match_dataset():
    """Same seed, same pixels as the JAX package's synthetic dataset; the
    batch is RGB and tiles the distinct scenes."""
    ds = SyntheticDetectionDataset(n=3, imgsz=96, nc=2, seed=7)
    for i in range(3):
        np.testing.assert_array_equal(synthetic_scene(i, 96, 2, seed=7), ds[i]["img"])
    batch = synthetic_batch(5, imgsz=96, n=3, seed=7)
    assert batch.shape == (5, 96, 96, 3) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch[4], ds[1]["img"][..., ::-1])
