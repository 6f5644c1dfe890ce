"""The segment and pose tasks' data path against the JAX package's (cv2) on
the CPU: the synthetic scenes' masks and keypoints, the float32 mask warp
and the nearest resize against cv2 5, the host pipeline's planes
(letterbox, mosaic4/9, copy-paste, the warp, the flips with `flip_idx`),
`collate`'s planes, the loader at one worker, `Masks.xy`'s border follower
against `cv2.findContours`, `Results.tojson`, and the `Bboxes`/`Instances`
containers. Tolerances, each with its reason:

* the warp of a float32 mask: cv2's vector code bit for bit where the
  output's width is a multiple of 16; cv2 computes the last (width mod 16)
  pixels of a row in scalar code whose coordinates round differently
  (`data/imgproc.py`): a few float32 spacings of a source coordinate times
  a mask's unit step, so there 5e-5 (1.4e-5 seen);
* everything else exactly: the same draws, the same float64 arithmetic on
  the labels, the same pixels at 64 px (a multiple of 16), the same
  integer contours.
"""
import json
import math
import random
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

import mgdt_yolo_tpu.data.augment as J
from mgdt_yolo_tpu.data.build import DataLoader as JaxDataLoader
from mgdt_yolo_tpu.data.build import collate as jax_collate
from mgdt_yolo_tpu.data.dataset import SyntheticDetectionDataset as JaxSynthetic
from mgdt_yolo_tpu.engine.results import Results as JaxResults
from mgdt_yolo_tpu.utils import instance as JI
import mgdt_yolo_tpu_torch.data.augment as P
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS
from mgdt_yolo_tpu_torch.data import imgproc
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.engine.results import Results
from mgdt_yolo_tpu_torch.utils import instance as PI
from mgdt_yolo_tpu_torch.utils.contours import contour_area, find_external_contours
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = 64
ALL_ON = {"degrees": 10.0, "shear": 2.0, "perspective": 0.0005, "mixup": 0.5, "mosaic9": 0.5,
          "copy_paste": 0.5, "flipud": 0.3, "fliplr": 0.5}
FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]  # COCO's left/right
WARP_TAIL = 5e-5


def _items(task, n=12, imgsz=S, seed=3):
    ds = SyntheticDetectionDataset(n=n, imgsz=imgsz, seed=seed, task=task)
    return [ds[i] for i in range(n)]


def _same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_synthetic_task_labels_match_jax(task):
    theirs = JaxSynthetic(n=5, imgsz=80, seed=2, task=task)
    ours = SyntheticDetectionDataset(n=5, imgsz=80, seed=2, task=task)
    for i in range(5):
        a, b = theirs[i], ours[i]
        key = "masks" if task == "segment" else "keypoints"
        assert key in b and ("keypoints" if task == "segment" else "masks") not in b
        for k in ("img", "boxes", "cls", key):
            np.testing.assert_array_equal(b[k], a[k])
    assert int((ours[0].get("keypoints", np.zeros((1, 17, 3)))[..., 2] > 0).sum(1).max()) \
        in (0, 3)


def test_float_mask_warps_and_nearest_resize_are_cv2s():
    rng = np.random.default_rng(0)
    for t in range(6):
        h, w = (int(v) for v in rng.integers(40, 120, 2))
        m = np.zeros((2, h, w), np.float32)
        m[0, h // 5:h // 2, w // 4:w - 5] = 1.0
        m[1] = rng.random((h, w)) < 0.3
        r = random.Random(t)
        R = np.eye(3)
        R[:2] = cv2.getRotationMatrix2D((0, 0), r.uniform(-10, 10), r.uniform(0.6, 1.4))
        T = np.eye(3)
        T[:2, 2] = r.uniform(-15, 15), r.uniform(-15, 15)
        M = T @ R
        if t % 2:
            M[2, :2] = r.uniform(-5e-4, 5e-4), r.uniform(-5e-4, 5e-4)
        dsize = (64 if t < 3 else w + 3, h - 4)
        got = P.warp_masks(m, M, dsize, bool(t % 2))
        for k in range(2):
            want = (cv2.warpPerspective(m[k], M, dsize=dsize, borderValue=0) if t % 2 else
                    cv2.warpAffine(m[k], M[:2], dsize=dsize, borderValue=0))
            d = np.abs(got[k] - want)
            body = dsize[0] - dsize[0] % 16
            assert not d[:, :body].any(), (t, k)
            assert d.max() <= WARP_TAIL, (t, k, d.max())
        for size in ((w // 4, h // 4), (w * 2 + 1, h + 7), (13, 5)):
            np.testing.assert_array_equal(imgproc.resize_nearest(m[1], size),
                                          cv2.resize(m[1], size, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("task", ["segment", "pose"])
@pytest.mark.parametrize("keys", ["defaults", "all-on"])
def test_train_transform_planes_match_jax(task, keys):
    """The pipeline over seeds and buffer sizes (0 to 11 items): the
    image, boxes, classes and the masks or keypoints exactly, the rng left
    in the same state; the left-right flip swaps the keypoints by
    `flip_idx`."""
    hyp = {**TRAIN_DEFAULTS, **(ALL_ON if keys == "all-on" else {"fliplr": 0.5})}
    items = _items(task)
    fi = FLIP_IDX if task == "pose" else None
    for seed in range(16):
        buf = items[1:1 + seed % 12]
        r1, r2 = random.Random(seed), random.Random(seed)
        want = J.train_transform(items[0], S, SimpleNamespace(**hyp), buf, r1, flip_idx=fi)
        got = P.train_transform(items[0], S, hyp, buf, r2, flip_idx=fi)
        assert r1.getstate() == r2.getstate()
        _same(got, want, f"{task} {keys} {seed}")
    if task == "pose":  # a certain flip: the slots swapped by flip_idx, or not
        flip = {**hyp, "fliplr": 1.0, "mosaic": 0.0}
        a = P.train_transform(items[0], S, flip, [], random.Random(0), flip_idx=fi)
        b = P.train_transform(items[0], S, flip, [], random.Random(0))
        np.testing.assert_array_equal(a["keypoints"], b["keypoints"][:, fi])


def test_mosaics_and_copy_paste_planes_match_jax():
    """mosaic4 and mosaic9 of segment items, and of pose items with
    box-only tiles among them (their keypoint slots all invisible), and
    copy-paste of masks, over seeds."""
    seg, pose = _items("segment", 9, seed=4), _items("pose", 9, seed=5)
    plain = _items("detect", 9, seed=6)
    for seed in range(4):
        mixed = [pose[0], plain[1], pose[2], plain[3], *pose[4:8], plain[8]]
        for items in (seg, mixed):
            r1, r2 = random.Random(seed), random.Random(seed)
            for fn in ("mosaic4", "mosaic9"):
                want = getattr(J, fn)(items, S, r1)
                got = getattr(P, fn)(items, S, r2)
                assert r1.getstate() == r2.getstate()
                for a, b in zip(want[:3], got[:3]):
                    np.testing.assert_array_equal(b, a)
                _same(got[3], want[3], f"{fn} {seed}")
        k = P.mosaic4(mixed, S, random.Random(seed))[3]["keypoints"]
        assert (k[len(mixed[0]["boxes"]):len(mixed[0]["boxes"]) + len(plain[1]["boxes"]), :, 2]
                == 0).all()
        it = seg[seed]
        for p in (0.5, 1.0):
            r1, r2 = random.Random(seed), random.Random(seed)
            want = J.copy_paste(it["img"], it["boxes"], it["cls"], it["masks"], p=p, rng=r1)
            got = P.copy_paste(it["img"], it["boxes"], it["cls"], it["masks"], p=p, rng=r2)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_collate_planes_and_loader_match_jax(task):
    """`collate`'s planes (train items, and letterboxed validation items
    whose masks are resized, not letterboxed, as JAX's) and two epochs of
    the host-path loader at one worker, b4, against JAX's."""
    items = _items(task, 6)
    train = [J.train_transform(items[i], S, SimpleNamespace(**TRAIN_DEFAULTS), items[:4],
                               random.Random(i)) for i in range(4)]
    val = _items(task, 3, imgsz=48, seed=8)
    for batch, size, tr in ((train, S, True), (val, S, False), (val, (48, 64), False)):
        want, got = jax_collate(batch, size, 24, tr), collate(batch, size, 24, tr)
        want.pop("metas", None), got.pop("metas", None)
        _same(got, want, f"collate {size} {tr}")
        assert ("masks" if task == "segment" else "keypoints") in got
    empty = [{**items[0], "boxes": np.zeros((0, 4), np.float32),
              "cls": np.zeros((0,), np.float32)}]
    _same(collate(empty, S, 8), jax_collate(empty, S, 8, True), "no objects")
    theirs = JaxDataLoader(JaxSynthetic(n=12, imgsz=S, seed=1, task=task), 4, S, train=True,
                           hyp=SimpleNamespace(**TRAIN_DEFAULTS), seed=2, workers=1)
    ours = DataLoader(SyntheticDetectionDataset(n=12, imgsz=S, seed=1, task=task), 4, S,
                      train=True, hyp=dict(TRAIN_DEFAULTS), seed=2, workers=2)
    assert ours.max_gt == theirs.max_gt
    for epoch in range(2):
        theirs.set_epoch(epoch)
        ours.set_epoch(epoch)
        for a, b in zip(list(theirs), list(ours)):
            _same(b, a, f"loader {epoch}")


def _masks(rng, n, h, w):
    """Seeded masks: random blobs with holes, touching discs, thin walls
    (one pixel wide rings) and speckle."""
    out = []
    for t in range(n):
        m = np.zeros((h, w), bool)
        yy, xx = np.ogrid[:h, :w]
        kind = t % 4
        if kind == 0:
            m = rng.random((h, w)) < rng.uniform(0.3, 0.7)
        elif kind == 1:
            for _ in range(rng.integers(2, 6)):
                y, x, r = rng.integers(0, h), rng.integers(0, w), rng.integers(2, 9)
                m |= (yy - y) ** 2 + (xx - x) ** 2 <= r * r
            for _ in range(rng.integers(1, 4)):
                y, x, r = rng.integers(0, h), rng.integers(0, w), rng.integers(1, 4)
                m &= ~((yy - y) ** 2 + (xx - x) ** 2 <= r * r)
        elif kind == 2:
            y1, x1 = rng.integers(2, h // 2), rng.integers(2, w // 2)
            y2, x2 = y1 + rng.integers(4, h // 2), x1 + rng.integers(4, w // 2)
            m[y1:y2, x1:x2] = True
            m[y1 + 1:y2 - 1, x1 + 1:x2 - 1] = False   # a one-pixel ring
            m[(y1 + y2) // 2, (x1 + x2) // 2] = True  # a dot in its hole
            m[y2:y2 + 3, x2:x2 + 3] = True            # a blob touching its corner
        else:
            for _ in range(rng.integers(1, 5)):
                y1, x1 = rng.integers(0, h), rng.integers(0, w)
                m[y1:y1 + rng.integers(1, 15), x1:x1 + rng.integers(1, 15)] ^= True
        out.append(m)
    return out


def test_contours_are_cv2s_point_for_point():
    rng = np.random.default_rng(1)
    n = 0
    for m in _masks(rng, 160, 37, 53) + [np.zeros((9, 9), bool), np.ones((5, 7), bool)]:
        want = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                cv2.CHAIN_APPROX_SIMPLE)[0]
        got = find_external_contours(m)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
            assert contour_area(b) == cv2.contourArea(a)
        n += len(got)
    assert n > 300


def test_masks_keypoints_and_tojson_match_jax():
    """`Masks.xy`/`xyn` (the largest contour, by cv2 in JAX), `Keypoints`,
    `keys`, `update` and `tojson`'s segments and keypoints fields."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (37, 53, 3), np.uint8)
    boxes = np.array([[1, 2, 30, 20, 0.9, 0], [5, 5, 50, 35, 0.4, 1], [0, 0, 9, 9, 0.2, 1]],
                     np.float32)
    masks = np.stack(_masks(rng, 3, 37, 53)).astype(np.float32)
    masks[2] = 0
    kpts = np.concatenate([rng.uniform(0, 50, (3, 17, 2)), rng.integers(0, 3, (3, 17, 1))],
                          -1).astype(np.float32)
    names = {0: "sow", 1: "piglet"}
    for kw in ({"masks": masks}, {"keypoints": kpts}, {"keypoints": kpts[..., :2]},
               {"masks": masks, "keypoints": kpts}):
        ours = Results(img, "a.png", names, boxes, **kw)
        theirs = JaxResults(img, "a.png", names, boxes, **kw)
        assert ours.keys == theirs.keys
        for norm in (False, True):
            assert json.loads(ours.tojson(norm)) == json.loads(theirs.tojson(norm))
        if "masks" in kw:
            for a, b in zip(ours.masks.xy, theirs.masks.xy):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(ours.masks.xyn, theirs.masks.xyn):
                np.testing.assert_array_equal(a, b)
            assert ours.masks.xy[2].shape == (0, 2)
        if "keypoints" in kw:
            np.testing.assert_array_equal(ours.keypoints.xyn, theirs.keypoints.xyn)
            assert (ours.keypoints.conf is None) == (theirs.keypoints.conf is None)
    r = Results(img, "a.png", names, boxes).update(masks=masks)
    assert r.keys == ["boxes", "masks"] and len(r.masks) == 3
    with pytest.raises(NotImplementedError, match="item 8"):
        Results(img, "a.png", names, boxes, probs=np.ones(2))


def test_instance_containers_match_jax():
    rng = np.random.default_rng(3)
    b = np.sort(rng.uniform(0, 50, (5, 2, 2)), 1).reshape(5, 4)[:, [0, 2, 1, 3]]
    segs = rng.uniform(0, 50, (5, 8, 2))
    kp = np.concatenate([rng.uniform(0, 50, (5, 17, 2)), rng.integers(0, 3, (5, 17, 1))], -1)
    for fmt in ("xyxy", "xywh", "ltwh"):
        a = JI.Bboxes(b.copy(), "xyxy")
        p = PI.Bboxes(b.copy(), "xyxy")
        a.convert(fmt), p.convert(fmt)
        np.testing.assert_array_equal(p.bboxes, a.bboxes)
        np.testing.assert_array_equal(p.areas(), a.areas())
    ops = [("scale", (1.5, 0.5)), ("add_padding", (3.0, 4.0)), ("clip", (40, 45)),
           ("flipud", (45,)), ("fliplr", (40,)), ("normalize", (40, 45)),
           ("denormalize", (40, 45)), ("remove_zero_area_boxes", ())]
    ia = JI.Instances(b.copy(), segs.copy(), kp.copy(), bbox_format="xyxy", normalized=False)
    ip = PI.Instances(b.copy(), segs.copy(), kp.copy(), bbox_format="xyxy", normalized=False)
    for name, args in ops:
        ra, rp = getattr(ia, name)(*args), getattr(ip, name)(*args)
        if ra is not None:
            np.testing.assert_array_equal(rp, ra)
        for k in ("bboxes", "segments", "keypoints"):
            np.testing.assert_array_equal(getattr(ip, k), getattr(ia, k), err_msg=name)
    assert len(ip) == len(ia) and len(ip[[0, -1]]) == len(ia[[0, -1]]) == 2
    assert math.isclose(float(ip.bbox_areas.sum()), float(ia.bbox_areas.sum()))
