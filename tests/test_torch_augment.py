"""The port's device augmentation against the JAX package's, on the CPU:
K3's plain version (`ops/image.fused_augment_plain`) against JAX
`fused_augment`, `apply_augment` fed JAX's own draws against JAX
`device_augment`, the raw collate, and the port's draws.

Tolerances, each with its reason:

* `fused_augment_plain` against JAX `fused_augment`: 1e-5 absolute. Both
  run the same float32 operations in the same order; the only freedom is
  the last bit of a division or remainder, and the output is continuous
  across the hue sectors, so a last-bit move stays a last-bit move. Against
  the numpy `fused_augment_reference`: 1/255, the JAX test's own scale.
* `apply_augment` against JAX `device_augment` with the same draws:
  `mask_gt` and `gt_labels` exact, `gt_bboxes` 1e-4 px (float32 affine
  maps of pixel coordinates, ~1e-5 px apart at most). The image, HSV off:
  2/255. The warp is two bf16 matrix products per tile and a bf16 sum over
  the tiles; XLA and PyTorch may round a bf16 product or sum the other way
  (one bf16 step is 1 at values of 128-255), and the uint8 rounding that
  follows turns that into at most one grey level per rounding, two in
  all. HSV on: the same uint8 images, one level apart at a few pixels, go
  through the HSV gain; a one-level change moves an output by at most
  about one level times the value gain (<= 1.4) plus the saturation the
  hue moves with (hue is ill-conditioned only where saturation, and so the
  hue's weight, is small): 4/255. Values more than 1e-6 apart must stay
  under 1% (observed 0.002-0.18%, largest 2/255 with HSV off and 1.9/255
  with it on); about half of all values differ by a last bit, because XLA
  computes the division by 255 as a product with its reciprocal.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.data.build import collate_raw as jax_collate_raw
from mgdt_yolo_tpu.ops.device_augment import device_augment as jax_device_augment
from mgdt_yolo_tpu.ops.pallas_image import fused_augment as jax_fused_augment
from mgdt_yolo_tpu.ops.pallas_image import fused_augment_reference
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate_raw, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.ops import cuda_image
from mgdt_yolo_tpu_torch.ops.device_augment import apply_augment, augment_draws
from mgdt_yolo_tpu_torch.ops.image import fused_augment_plain

S = 128


# ---------------------------------------------------------------------------
# K3's plain version
# ---------------------------------------------------------------------------

def _k3_inputs(seed=0, B=4, H=48, W=64):
    """Random pixels with planted grey, black, white, saturated and tied
    pixels; gains drawn as the trainer draws them (image 0), pushing hue
    across the wrap (images 1-3); all four flip combinations."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    planted = [(v, v, v) for v in (0, 1, 17, 128, 254, 255)] + \
        [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (0, 255, 255),
         (255, 0, 255), (200, 200, 10), (10, 200, 200), (200, 10, 200), (255, 1, 0),
         (255, 0, 1), (1, 0, 255)]
    for j, px in enumerate(planted):
        imgs[:, j % H, (3 * j) % W] = px
        imgs[:, (5 * j + 7) % H, (j + 11) % W] = px
    gains = np.empty((B, 3), np.float32)
    gains[0] = 1.0 + rng.uniform(-1, 1, 3) * np.array([0.015, 0.7, 0.4])
    gains[1:] = np.array([[1.015, 1.7, 0.6], [1.9, 0.3, 1.4], [3.7, 1.0, 1.0]])[:B - 1]
    flips = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.int32)[:B]
    return imgs, gains, flips


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_augment_plain_matches_jax(seed):
    imgs, gains, flips = _k3_inputs(seed)
    got = fused_augment_plain(torch.from_numpy(imgs), torch.from_numpy(gains),
                              torch.from_numpy(flips)).numpy()
    want = np.asarray(jax_fused_augment(jnp.asarray(imgs), jnp.asarray(gains),
                                        jnp.asarray(flips)))
    assert got.dtype == np.float32 and got.shape == imgs.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, fused_augment_reference(imgs, gains, flips),
                               rtol=0, atol=1 / 255)
    # hue did cross the wrap: image 3's gain rotates every saturated pixel
    assert np.abs(got[3] - imgs[3, ::-1, ::-1] / 255.0).max() > 0.5


def test_fused_augment_wrapper_takes_cpu_and_cuda_only():
    imgs, gains, flips = _k3_inputs(0, B=2, H=8, W=8)
    before = cuda_image.launches
    out = cuda_image.fused_augment(torch.from_numpy(imgs), torch.from_numpy(gains),
                                   torch.from_numpy(flips))
    assert out.shape == (2, 8, 8, 3) and cuda_image.launches == before
    with pytest.raises(ValueError):
        cuda_image.fused_augment(torch.empty((2, 8, 8, 3), dtype=torch.uint8, device="meta"),
                                 torch.from_numpy(gains), torch.from_numpy(flips))


def test_fused_augment_simt_wrapper_takes_cpu_and_cuda_only():
    """The SIMT K3, the Hopper K3's A/B baseline: a CPU tensor goes to the
    plain version without counting a launch of either kernel."""
    imgs, gains, flips = _k3_inputs(1, B=3, H=6, W=10)
    args = [torch.from_numpy(a) for a in (imgs, gains, flips)]
    before = (cuda_image.launches, cuda_image.simt_launches)
    out = cuda_image.fused_augment_simt(*args)
    assert (cuda_image.launches, cuda_image.simt_launches) == before
    assert torch.equal(out, fused_augment_plain(*args))
    with pytest.raises(ValueError):
        cuda_image.fused_augment_simt(torch.empty((3, 6, 10, 3), dtype=torch.uint8,
                                                  device="meta"), *args[1:])


def _hues():
    """Every hue ratio (before /6) that K3 computes from a uint8 triple, in
    float32 as the kernels compute it: the 2^24 triples in 4 chunks."""
    t = np.arange(256, dtype=np.float32) / np.float32(255)
    found = []
    gb = np.arange(1 << 16)
    for r0 in range(0, 256, 64):
        r = np.repeat(t[r0:r0 + 64], 1 << 16)
        g, b = np.tile(t[gb >> 8], 64), np.tile(t[gb & 255], 64)
        cmax, cmin = np.maximum(r, np.maximum(g, b)), np.minimum(r, np.minimum(g, b))
        delta = (cmax - cmin) + np.float32(1e-12)
        is_r = cmax == r
        is_g = ~is_r & (cmax == g)
        q = np.where(is_r, g - b, np.where(is_g, b - r, r - g)) / delta
        h = np.where(is_r, np.where(q < 0, q + np.float32(6), q),
                     q + np.where(is_g, np.float32(2), np.float32(4)))
        found.append(np.unique(h.astype(np.float32)))
    return np.unique(np.concatenate(found))


def test_k3_division_free_forms_give_the_same_bits():
    """The Hopper K3 (`csrc/fused_augment.cu`) rewrites three operations of
    the SIMT K3 without a division or fmodf; each must give the same
    float32 bits: x / 6 as Markstein's correction q1 = RN(x z), r =
    fma(-q1, 6, x), RN(q1 + r z) with z = RN(1/6), on every hue ratio the
    2^24 RGB triples give (the FMAs emulated exactly in float64, and with
    rationals where the last rounding is close); fmod(x, 1) and fmod(x, 2)
    as x - n trunc(x / n) with x's sign; the hue sector as an integer
    remainder."""
    from fractions import Fraction
    h = _hues()
    z = np.float32(1) / np.float32(6)
    q1 = (h.astype(np.float64) * np.float64(z)).astype(np.float32)
    r = (h.astype(np.float64) - 6.0 * q1.astype(np.float64)).astype(np.float32)
    exact = q1.astype(np.float64) + r.astype(np.float64) * np.float64(z)
    got = exact.astype(np.float32)
    lo, hi = np.nextafter(got, np.float32(-np.inf)), np.nextafter(got, np.float32(np.inf))
    mids = (got.astype(np.float64) + np.stack([lo, hi]).astype(np.float64)) / 2
    for k in np.nonzero((np.abs(mids - exact) <= 4 * np.spacing(exact)).any(axis=0))[0]:
        want = Fraction(float(q1[k])) + Fraction(float(r[k])) * Fraction(float(z))
        got[k] = min((lo[k], got[k], hi[k]), key=lambda c: (
            abs(Fraction(float(c)) - want), int(np.float32(c).view(np.uint32)) & 1))
    assert h.size > 100000
    assert np.array_equal(got.view(np.uint32), (h / np.float32(6)).view(np.uint32))

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-10, 10, 100000), rng.uniform(-1, 1, 100000) * 1e-30,
                        np.arange(-16, 16, 0.5), [0.0, -0.0, 6.0, 2.0 ** 23 + 1, 3e38, -3e38]])
    x = x.astype(np.float32)
    for n in (1, 2):
        rewrite = np.copysign(x - np.float32(n) * np.trunc(x * np.float32(1 / n)), x)
        assert np.array_equal(rewrite.view(np.uint32), np.fmod(x, np.float32(n)).view(np.uint32))
    for m in range(-20, 21):
        s = np.fmod(np.float32(m), np.float32(6))
        s = s + np.float32(6) if s < 0 else s
        assert int(s) == (m % 6)


# ---------------------------------------------------------------------------
# apply_augment against JAX device_augment, with JAX's draws
# ---------------------------------------------------------------------------

def _items(seed=0, n=4):
    """Raw items of several content sizes at most S, with boxes, a thin one
    (3 px wide) among them that a downscale drops."""
    rng = np.random.default_rng(seed)
    items = []
    for j in range(n):
        h, w = [(96, 128), (128, 128), (112, 80), (64, 100)][j % 4]
        img = rng.integers(60, 200, (h, w, 3), dtype=np.uint8)
        boxes, cls = [], []
        for k in range(int(rng.integers(2, 6))):
            bw, bh = rng.uniform(0.15, 0.5) * w, rng.uniform(0.15, 0.5) * h
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            if k == 0:
                bw = 3.0
            img[int(y1):int(y1 + bh), int(x1):int(x1 + bw)] = rng.integers(0, 256, 3)
            boxes.append([x1, y1, x1 + bw, y1 + bh])
            cls.append(k % 2)
        items.append({"img": img, "boxes": np.asarray(boxes, np.float32),
                      "cls": np.asarray(cls, np.float32)})
    return items


@partial(jax.jit, static_argnums=(1, 2))
def jax_draws(key, B, s, mosaic_p, scale, translate, fliplr, flipud, hsv_h, hsv_s, hsv_v):
    """The draws of `device_augment` for B images at s px: its key split and
    distributions, with its traced float32 arguments."""
    k_pick, k_center, k_mosaic, k_scale, k_tx, k_ty, k_flip, k_hsv = jax.random.split(key, 8)
    picks = jnp.concatenate([jnp.arange(B, dtype=jnp.int32)[:, None],
                             jax.random.randint(k_pick, (B, 3), 0, B, jnp.int32)], axis=1)
    centers = jax.random.uniform(k_center, (B, 2), jnp.float32, s / 2, 2 * s - s / 2)
    use_mosaic = jax.random.uniform(k_mosaic, (B,)) < mosaic_p
    sf = jax.random.uniform(k_scale, (B,), jnp.float32, 1 - scale, 1 + scale)
    tx = jax.random.uniform(k_tx, (B,), jnp.float32, (0.5 - translate) * s,
                            (0.5 + translate) * s)
    ty = jax.random.uniform(k_ty, (B,), jnp.float32, (0.5 - translate) * s,
                            (0.5 + translate) * s)
    do_lr = jax.random.uniform(k_flip, (B,)) < fliplr
    do_ud = jax.random.uniform(jax.random.fold_in(k_flip, 1), (B,)) < flipud
    gains = 1.0 + jax.random.uniform(k_hsv, (B, 3), jnp.float32, -1.0, 1.0) * \
        jnp.asarray([hsv_h, hsv_s, hsv_v], jnp.float32)
    return {"picks": picks, "centers": centers, "use_mosaic": use_mosaic, "sf": sf,
            "tx": tx, "ty": ty, "flips": jnp.stack([do_lr, do_ud], 1).astype(jnp.int32),
            "gains": gains}


# (name, key, mosaic_p, scale, translate, fliplr, flipud, hsv on)
AUG_CASES = [("mosaic", 0, 1.0, 0.5, 0.1, 0.0, 0.0, False),
             ("mosaic-hsv", 1, 1.0, 0.5, 0.1, 0.0, 0.0, True),
             ("solo", 2, 0.0, 0.5, 0.1, 0.0, 0.0, False),
             ("solo-hsv", 3, 0.0, 0.5, 0.1, 0.0, 0.0, True),
             ("fliplr-flipud", 4, 1.0, 0.5, 0.1, 1.0, 1.0, False),
             ("mixed-shrink", 5, 0.5, 0.9, 0.2, 0.5, 0.0, True),
             ("solo-shrink", 8, 0.0, 0.9, 0.1, 0.0, 0.0, False)]


@pytest.fixture(scope="module")
def raw_batch():
    items = _items()
    got, want = collate_raw(items, S, 24), jax_collate_raw(items, S, 24)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


@pytest.mark.parametrize("case", AUG_CASES, ids=[c[0] for c in AUG_CASES])
def test_apply_augment_matches_jax(case, raw_batch):
    name, k, mosaic_p, scale, translate, fliplr, flipud, hsv = case
    h = (0.015, 0.7, 0.4) if hsv else (0.0, 0.0, 0.0)
    key = jax.random.PRNGKey(k)
    params = dict(mosaic_p=mosaic_p, scale=scale, translate=translate, fliplr=fliplr,
                  flipud=flipud, hsv_h=h[0], hsv_s=h[1], hsv_v=h[2])
    want = jax.device_get(jax_device_augment({k_: jnp.asarray(v) for k_, v in raw_batch.items()},
                                             key, imgsz=S, max_out=24, **params))
    draws = {k_: torch.from_numpy(np.array(v)) for k_, v in
             jax.device_get(jax_draws(key, 4, S, *params.values())).items()}
    got = apply_augment(to_device(raw_batch, "cpu"), draws, S, 24)
    np.testing.assert_array_equal(got["mask_gt"].numpy(), want["mask_gt"])
    np.testing.assert_array_equal(got["gt_labels"].numpy(), want["gt_labels"])
    np.testing.assert_allclose(got["gt_bboxes"].numpy(), want["gt_bboxes"], rtol=0, atol=1e-4)
    diff = np.abs(got["img"].numpy() - want["img"])
    # any difference: XLA divides by 255 as a product with 1/255, a last
    # bit apart from the division at about half the values; a grey level:
    # a warp product rounded the other way
    share, share_level = float((diff > 0).mean()), float((diff > 1e-6).mean())
    print(f"{name}: max |diff| {diff.max() * 255:.3f}/255, values that differ at all "
          f"{share:.3%}, by more than 1e-6 {share_level:.4%}")
    assert diff.max() <= (4 if hsv else 2) / 255 + 1e-6
    assert share_level < 0.01
    survivors = want["mask_gt"].sum()
    assert 0 < survivors < raw_batch["mask_gt"].sum() * (4 if mosaic_p else 1)
    if name == "fliplr-flipud":
        assert (draws["flips"] == 1).all()
    if name == "solo-shrink":    # box_candidates drops boxes in every image
        assert (want["mask_gt"].sum(1) < raw_batch["mask_gt"].sum(1)).all()


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

def test_augment_draws_shapes_ranges_and_seeding():
    def draws(seed):
        return augment_draws(8, S, torch.Generator().manual_seed(seed), mosaic_p=0.5,
                             scale=0.5, translate=0.1, fliplr=0.5, flipud=0.25)
    d = draws(3)
    assert d["picks"].shape == (8, 4) and d["picks"].dtype == torch.int32
    assert (d["picks"][:, 0] == torch.arange(8)).all()
    assert ((d["picks"] >= 0) & (d["picks"] < 8)).all()
    assert d["centers"].shape == (8, 2)
    assert ((d["centers"] >= S / 2) & (d["centers"] < 1.5 * S)).all()
    assert d["use_mosaic"].dtype == torch.bool and d["use_mosaic"].shape == (8,)
    assert ((d["sf"] >= 0.5) & (d["sf"] < 1.5)).all()
    for t in ("tx", "ty"):
        assert ((d[t] >= 0.4 * S) & (d[t] < 0.6 * S)).all()
    assert d["flips"].shape == (8, 2) and d["flips"].dtype == torch.int32
    assert set(d["flips"].unique().tolist()) <= {0, 1}
    dev = (d["gains"] - 1).abs().max(0).values
    assert (dev <= torch.tensor([0.015, 0.7, 0.4])).all()
    again, other = draws(3), draws(4)
    assert all(torch.equal(d[k], again[k]) for k in d)
    assert not torch.equal(d["gains"], other["gains"])
    off = augment_draws(8, S, torch.Generator().manual_seed(0), mosaic_p=0.0, fliplr=0.0)
    assert not off["use_mosaic"].any() and not off["flips"].any()


def test_raw_loader_ships_raw_batches():
    ds = SyntheticDetectionDataset(n=8, imgsz=64, seed=0)
    loader = DataLoader(ds, 4, 64, device_augment=True)
    b = next(iter(loader))
    assert set(b) == {"img", "img_hw", "gt_bboxes", "gt_labels", "mask_gt"}
    assert b["img"].dtype == np.uint8 and b["img"].shape == (4, 64, 64, 3)
    assert (b["img_hw"] == 64).all() and loader.max_gt == 24
    big = {"img": np.zeros((80, 64, 3), np.uint8), "boxes": np.zeros((0, 4), np.float32),
           "cls": np.zeros(0, np.float32)}
    with pytest.raises(ValueError):
        collate_raw([big], 64, 8)
