"""The port's host augmentation pipeline (`data/augment.py`, the loader's
host path in `data/build.py`, the trainer's routing) against the JAX
package's (`mgdt_yolo_tpu/data/augment.py`, `data/build.py`), on the CPU.

Each ported function is fed the same inputs and a `random.Random` of the
same seed on both sides. Tolerances, each with its reason:

* boxes, classes, the number of draws (the rng's state after the call),
  `max_gt`: bit for bit (the same double arithmetic and the same draws);
* pixels: bit for bit where every primitive is (the warps at widths of a
  multiple of 64, HSV at widths of a multiple of 32, the filters, the
  mosaics, mixup's numpy blend; `tests/test_torch_imgproc.py`), elsewhere
  one grey level in at most 0.1% of the values;
* an image that took Albumentations' CLAHE branch (p=0.01; the port's
  LAB round trip is within two levels of cv2's, see
  `tests/test_torch_imgproc.py`): within two levels after the branch alone,
  and within 20 levels in at most 10% of the values after the rest of the
  pipeline, since a difference of one level before the HSV jitter can move
  a hue by one step, up to 1/30 of a sector (8.5 levels) after it, and two
  levels two steps.
"""
import logging
import random
from types import SimpleNamespace

import numpy as np
import pytest

from mgdt_yolo_tpu.cfg import get_cfg
from mgdt_yolo_tpu.data import augment as J
from mgdt_yolo_tpu.data.build import DataLoader as JaxDataLoader
from mgdt_yolo_tpu.data.dataset import SyntheticDetectionDataset as JaxSynthetic
from mgdt_yolo_tpu.engine.trainer import device_augment_unsupported as jax_unsupported
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS, UNAUGMENTED
from mgdt_yolo_tpu_torch.data import augment as P
from mgdt_yolo_tpu_torch.data import imgproc
from mgdt_yolo_tpu_torch.data.build import DataLoader, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.engine.trainer import (Trainer, check_augment_args,
                                                device_augment_unsupported)
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from test_torch_facade import one_torch_thread  # noqa: F401  (autouse)
from test_torch_predict import NPZ

S = 64
# every augmentation the host pipeline has, at the values phase 18 trains with
ALL_ON = {"degrees": 10.0, "shear": 2.0, "perspective": 0.0005, "mixup": 0.5, "mosaic9": 0.5,
          "copy_paste": 0.5, "flipud": 0.3, "fliplr": 0.5}
CLAHE_LIMIT, CLAHE_SHARE = 20, 0.1


def _items(n=12, imgsz=S, seed=3):
    ds = SyntheticDetectionDataset(n=n, imgsz=imgsz, seed=seed)
    return [ds[i] for i in range(n)]


def _pixels(got, want, what, exact=True):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, what
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if exact:
        assert not d.any(), (what, int(d.max()))
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (what, int(d.max()), (d > 0).mean())


def _same_labels(a, b, what):
    for k in ("boxes", "cls"):
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.fixture
def clahe_calls(monkeypatch):
    """The number of images the port's pipeline took through CLAHE."""
    calls = []
    real = imgproc.clahe

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(imgproc, "clahe", counted)
    return calls


# ---------------------------------------------------------------------------
# the functions, one by one
# ---------------------------------------------------------------------------

PERSPECTIVE_CASES = {"default": {}, "degrees-shear": {"degrees": 30.0, "shear": 5.0},
                     "perspective": {"degrees": 10.0, "perspective": 0.001}}


@pytest.mark.parametrize("case", PERSPECTIVE_CASES)
def test_random_perspective_matches_jax(case):
    """Plain (border 0, 128 wide: exact) and as after a mosaic (border
    -s/2 of a 2s canvas, 64 wide: exact), over seeds."""
    kw = {**{k: TRAIN_DEFAULTS[k] for k in ("degrees", "translate", "scale", "shear",
                                            "perspective")}, **PERSPECTIVE_CASES[case]}
    items = _items(4, 128)
    for seed in range(6):
        it = items[seed % 4]
        img = it["img"][:96] if seed % 2 else it["img"]
        border = (-32, -32) if seed >= 3 else (0, 0)
        if seed >= 3:
            img = np.ascontiguousarray(img[:128, :128])
        r1, r2 = random.Random(seed), random.Random(seed)
        a_img, a_box, a_cls, extras = J.random_perspective(img, it["boxes"], it["cls"],
                                                           border=border, rng=r1, **kw)
        b_img, b_box, b_cls, b_extras = P.random_perspective(img, it["boxes"], it["cls"],
                                                             border=border, rng=r2, **kw)
        assert extras == b_extras == {} and r1.getstate() == r2.getstate()
        _same_labels({"boxes": a_box, "cls": a_cls}, {"boxes": b_box, "cls": b_cls}, case)
        _pixels(b_img, a_img, f"{case} {seed}", exact=b_img.shape[1] % 64 == 0)


def test_box_candidates_and_bbox_ioa_match_jax():
    rng = np.random.default_rng(5)
    a = np.sort(rng.uniform(0, 100, (40, 2, 2)), 1).reshape(40, 4)[:, [0, 2, 1, 3]]
    b = a + rng.uniform(-10, 10, a.shape)
    np.testing.assert_array_equal(P.box_candidates(a.T, b.T), J.box_candidates(a.T, b.T))
    np.testing.assert_array_equal(P.box_candidates(a.T, b.T, area_thr=0.5),
                                  J.box_candidates(a.T, b.T, area_thr=0.5))
    np.testing.assert_array_equal(P.bbox_ioa(a, b), J.bbox_ioa(a, b))
    np.testing.assert_array_equal(P.bbox_ioa(a[:3].astype(np.float32), b[5:9].astype(np.float32)),
                                  J.bbox_ioa(a[:3].astype(np.float32), b[5:9].astype(np.float32)))


def _sized(items, seed):
    """The items cut to assorted sizes (long side at most S), as the loader
    hands them on after `resize_long_side`."""
    rng = np.random.default_rng(seed)
    out = []
    for it in items:
        h, w = int(rng.integers(S // 2, S + 1)), int(rng.integers(S // 2, S + 1))
        keep = (it["boxes"][:, 2] <= w) & (it["boxes"][:, 3] <= h)
        out.append({"img": np.ascontiguousarray(it["img"][:h, :w]), "boxes": it["boxes"][keep],
                    "cls": it["cls"][keep]})
    out[1] = {**out[1], "boxes": np.zeros((0, 4), np.float32),
              "cls": np.zeros((0,), np.float32)}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mosaics_match_jax(seed):
    items = _sized(_items(9, S, seed=seed), seed)
    r1, r2 = random.Random(seed), random.Random(seed)
    want, got = J.mosaic4(items, S, r1), P.mosaic4(items, S, r2)
    assert r1.getstate() == r2.getstate()
    _same_labels({"boxes": want[1], "cls": want[2]}, {"boxes": got[1], "cls": got[2]}, "mosaic4")
    np.testing.assert_array_equal(got[0], want[0])
    want = J.mosaic9(items, S, r1)
    got = P.mosaic9(items, S)
    assert want[3] == got[3] == {} and r1.getstate() == r2.getstate()
    _same_labels({"boxes": want[1], "cls": want[2]}, {"boxes": got[1], "cls": got[2]}, "mosaic9")
    np.testing.assert_array_equal(got[0], want[0])


def test_mixup_and_copy_paste_match_jax():
    items = _items(4, S, seed=7)
    for seed in range(3):
        r1, r2 = random.Random(seed), random.Random(seed)
        a, b = J.mixup(items[0], items[1], r1), P.mixup(items[0], items[1], r2)
        assert r1.getstate() == r2.getstate()
        _same_labels(a, b, "mixup")
        np.testing.assert_array_equal(b["img"], a["img"])
    # copy-paste on instance masks (the segment task's input), p 0, 0.5, 1
    it = items[2]
    masks = np.zeros((len(it["boxes"]), S, S), np.float32)
    for j, (x1, y1, x2, y2) in enumerate(it["boxes"]):
        masks[j, int(y1):int(y2), int(x1):int(x2)] = 1.0
    for p in (0.0, 0.5, 1.0):
        for seed in range(3):
            r1, r2 = random.Random(seed), random.Random(seed)
            want = J.copy_paste(it["img"], it["boxes"], it["cls"], masks, p=p, rng=r1)
            got = P.copy_paste(it["img"], it["boxes"], it["cls"], masks, p=p, rng=r2)
            assert r1.getstate() == r2.getstate()
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    r1, r2 = random.Random(0), random.Random(0)
    assert P.copy_paste(it["img"], it["boxes"], it["cls"], None, rng=r2)[3] is None
    assert r1.getstate() == r2.getstate()


def _branch_seed(branch):
    """A seed whose Albumentations draws fire `branch` (0 Blur, 1 MedianBlur,
    2 ToGray, 3 CLAHE) and no other: the call's p draw, then one draw per
    branch, each fired branch drawing its size or clip limit."""
    for seed in range(100000):
        r = random.Random(seed)
        r.random()
        fired = []
        for k in range(4):
            if r.random() < 0.01:
                fired.append(k)
                if k < 2:
                    r.choice([3, 5, 7])
                elif k == 3:
                    r.uniform(1.0, 4.0)
        if fired == [branch]:
            return seed
    raise AssertionError(branch)


@pytest.mark.parametrize("branch", [0, 1, 2, 3], ids=["blur", "median", "gray", "clahe"])
def test_albumentations_branches_match_jax(branch):
    """Each branch forced by its seed, on two 64 px scenes; an image without
    labels takes no draw."""
    seed = _branch_seed(branch)
    for it in _items(2, S, seed=branch):
        r1, r2 = random.Random(seed), random.Random(seed)
        want = J.Albumentations(p=1.0)(it["img"], it["boxes"], it["cls"], r1)
        got = P.Albumentations(p=1.0)(it["img"], it["boxes"], it["cls"], r2)
        assert r1.getstate() == r2.getstate()
        assert got[1] is it["boxes"] and got[2] is it["cls"] and want[1] is it["boxes"]
        assert not np.array_equal(got[0], it["img"])
        if branch == 3:
            d = np.abs(got[0].astype(np.int32) - want[0])
            assert d.max() <= 2 and (d > 0).mean() <= 0.1, (int(d.max()), (d > 0).mean())
        else:
            np.testing.assert_array_equal(got[0], want[0])
    r1, r2 = random.Random(seed), random.Random(seed)
    empty = np.zeros((0,), np.float32)
    J.Albumentations(p=1.0)(it["img"], it["boxes"][:0], empty, r1)
    P.Albumentations(p=1.0)(it["img"], it["boxes"][:0], empty, r2)
    assert r1.getstate() == r2.getstate() == random.Random(seed).getstate()


def test_augment_hsv_matches_jax():
    items = _items(3, S, seed=9)
    for gains in ((0.015, 0.7, 0.4), (0.1, 0.9, 0.9), (0.0, 0.0, 0.0), (0.0, 0.5, 0.0)):
        for seed in range(3):
            r1, r2 = random.Random(seed), random.Random(seed)
            want = J.augment_hsv(items[seed]["img"], *gains, rng=r1)
            got = P.augment_hsv(items[seed]["img"], *gains, rng=r2)
            assert r1.getstate() == r2.getstate()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keys", ["defaults", "all-on"])
def test_train_transform_matches_jax(keys, clahe_calls):
    """The whole pipeline over seeds and buffer sizes (0 to 11 items: no
    mosaic below 3, no 3x3 mosaic below 8), at the JAX defaults and with
    every augmentation on."""
    hyp = {**TRAIN_DEFAULTS, **(ALL_ON if keys == "all-on" else {})}
    items = _items(12, S, seed=3)
    for seed in range(24):
        buf = items[1:1 + seed % 12]
        r1, r2 = random.Random(seed), random.Random(seed)
        n_clahe = len(clahe_calls)
        want = J.train_transform(items[0], S, SimpleNamespace(**hyp), buf, r1)
        got = P.train_transform(items[0], S, hyp, buf, r2)
        assert r1.getstate() == r2.getstate(), seed
        assert set(got) == {"img", "boxes", "cls"}
        _same_labels(want, got, f"{keys} {seed}")
        if len(clahe_calls) > n_clahe:
            d = np.abs(got["img"].astype(np.int32) - want["img"])
            assert d.max() <= CLAHE_LIMIT and (d > 0).mean() <= CLAHE_SHARE
        else:
            np.testing.assert_array_equal(got["img"], want["img"], err_msg=f"{keys} {seed}")


def test_segment_and_pose_items_raise_naming_item_8():
    """Items carrying `masks` or `keypoints` go through the pipeline as
    JAX's do (the segment and pose tasks; only classify, item 8, is left):
    letterboxed alone and in a mosaic with detect items, whose keypoint
    slots are then all invisible. `tests/test_torch_seg_pose_data.py` holds
    the planes over seeds."""
    it = _items(1)[0]
    n = len(it["boxes"])
    planes = {"masks": np.ones((n, S, S), np.float32),
              "keypoints": np.full((n, 17, 3), 2.0, np.float32)}
    for key, value in planes.items():
        item = {**it, key: value}
        r1, r2 = random.Random(0), random.Random(0)
        want = J.train_transform(item, S, SimpleNamespace(**TRAIN_DEFAULTS), [], r1)
        got = P.train_transform(item, S, TRAIN_DEFAULTS, [], r2)
        assert set(got) == {"img", "boxes", "cls", key} and r1.getstate() == r2.getstate()
        np.testing.assert_array_equal(got[key], want[key])
        r1, r2 = random.Random(0), random.Random(0)
        want = J.mosaic4([item, it, it, it], S, r1)
        got = P.mosaic4([item, it, it, it], S, r2)
        np.testing.assert_array_equal(got[3][key], want[3][key])
        assert len(got[3][key]) == 4 * n


# ---------------------------------------------------------------------------
# the loader and the trainer
# ---------------------------------------------------------------------------

LOADER_CASES = {"defaults-1": ({}, 1, 64), "all-on-3": (ALL_ON, 3, 64),
                "resized-2": ({"mixup": 0.3}, 2, 96)}


@pytest.mark.parametrize("case", LOADER_CASES)
def test_loader_two_epochs_match_jax_at_one_worker(case, clahe_calls):
    """Two epochs of 40 synthetic scenes (at 64 px, or 96 px resized to 64
    on their long side), b4: the port at 1, 2 or 3 threads gives the JAX
    loader's batches at `workers=1`, the buffer carried from the first
    epoch into the second. Labels bit for bit; images as the functions'."""
    over, workers, src = LOADER_CASES[case]
    hyp = {**TRAIN_DEFAULTS, **over}
    theirs = JaxDataLoader(JaxSynthetic(n=40, imgsz=src, seed=1), 4, S, train=True,
                           hyp=SimpleNamespace(**hyp), seed=2, workers=1)
    ours = DataLoader(SyntheticDetectionDataset(n=40, imgsz=src, seed=1), 4, S, train=True,
                      hyp=hyp, seed=2, workers=workers)
    assert ours.max_gt == theirs.max_gt and ours.host_augment
    wide = 0
    for epoch in range(2):
        theirs.set_epoch(epoch)
        ours.set_epoch(epoch)
        want, got = list(theirs), list(ours)
        assert len(got) == len(want) == 10
        for a, b in zip(want, got):
            assert set(b) == {"img", "gt_labels", "gt_bboxes", "mask_gt"}
            for k in b:
                assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
                if k != "img":
                    np.testing.assert_array_equal(b[k], a[k], err_msg=f"{epoch} {k}")
            for x, y in zip(b["img"], a["img"]):
                d = np.abs(x.astype(np.int32) - y)
                if d.max() > 1 or (d > 0).mean() > 1e-3:
                    wide += 1
                    assert d.max() <= CLAHE_LIMIT and (d > 0).mean() <= CLAHE_SHARE
        assert len(ours.buffer) == len(theirs.dataset.buffer) == 32
    print(f"{case}: {len(clahe_calls)} CLAHE images, {wide} beyond one level")
    assert wide <= len(clahe_calls)
    for x, y in zip(ours.buffer, theirs.dataset.buffer):
        np.testing.assert_array_equal(x["img"], y["img"])


ROUTING_CASES = [{}, {"degrees": 10.0, "mixup": 0.3}, {"shear": 2.0},
                 {"mosaic9": 0.5, "copy_paste": 0.1, "perspective": 1e-4}]


@pytest.mark.parametrize("keys", ROUTING_CASES, ids=["none", "degrees-mixup", "shear",
                                                     "mosaic9-copy_paste-perspective"])
def test_routing_matches_jax(keys, caplog):
    """JAX's routing on the same keys: the device pipeline only with
    `device_augment=True` and none of the keys it cannot honour; else the
    host one, with JAX's warning where the device was asked for."""
    args = {**TRAIN_DEFAULTS, **keys}
    assert device_augment_unsupported(args) == jax_unsupported(get_cfg(overrides=keys)) == keys
    with caplog.at_level(logging.WARNING, "mgdt_yolo_tpu_torch.engine.trainer"):
        assert check_augment_args(args) is False
        assert not caplog.records
        assert check_augment_args({**args, "device_augment": True}) is (not keys)
    assert bool(caplog.records) is bool(keys)
    if keys:
        assert caplog.records[0].getMessage() == (
            f"device_augment=True cannot honor {device_augment_unsupported(args)} — falling "
            "back to the host "
            "augmentation pipeline")


class EpochRecorder:
    """A host-path loader that yields no batch and records, per epoch, the
    mosaic probability its items would be transformed with."""
    device_augment, max_gt = False, 8

    def __init__(self):
        self.hyp, self.seen = None, []

    def set_hyp(self, hyp):
        self.hyp = hyp

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return 1

    def __iter__(self):
        self.seen.append((self.epoch, self.hyp["mosaic"]))
        return iter(())


def test_trainer_defaults_take_the_host_path():
    """With JAX's default keys the `Trainer` builds a host-path loader of
    the synthetic scenes (no device augmentation function) and takes a
    micro-step on its first batch; with `device_augment=True` and `mixup`
    it falls back to the host path; a loader built without `hyp` takes the
    trainer's arguments."""
    args = {"imgsz": S, "batch": 2, "epochs": 1, "workers": 2, "amp": False, "val": False}
    model = DetectionModel.from_npz(NPZ, device="cpu")
    tr = Trainer(model, overrides=args)
    assert tr.device_augment is False and tr.augment_fn is None
    assert tr.loader.host_augment and tr.loader.hyp is tr.args and tr.loader.max_gt == 24
    batch = next(iter(tr.loader))
    assert batch["img"].shape == (2, S, S, 3) and "img_hw" not in batch
    m = tr.train_step(to_device(batch, "cpu"))
    assert all(np.isfinite(float(v)) for v in m.values()) and tr.step == 1
    fell_back = Trainer(model, overrides={**args, "device_augment": True, "mixup": 0.5})
    assert fell_back.device_augment is False and fell_back.loader.max_gt == 32
    # a loader built without `hyp` takes the trainer's arguments
    loader = DataLoader(SyntheticDetectionDataset(n=4, imgsz=S), 2, S)
    assert loader.hyp is None and loader.max_gt == 24
    unaug = Trainer(model, loader, overrides={**args, **UNAUGMENTED, "mixup": 0.5})
    assert loader.hyp is unaug.args and loader.max_gt == 32


def jax_close_mosaic(epochs, close_mosaic, start_epoch=0):
    """The mosaic probability of each epoch under the JAX trainer's rule
    (`mgdt_yolo_tpu/engine/trainer.py:508-510`): `mosaic=0` at `epoch ==
    epochs - close_mosaic`, kept for the later epochs of the run."""
    mosaic, seen = 1.0, []
    for epoch in range(start_epoch, epochs):
        if close_mosaic and epoch == epochs - close_mosaic:
            mosaic = 0.0
        seen.append((epoch, mosaic))
    return seen


@pytest.mark.parametrize("epochs,close_mosaic", [(3, 2), (3, 3), (2, 5), (3, 0)],
                         ids=["closes-at-1", "closes-at-0", "more-than-epochs", "off"])
def test_close_mosaic_by_epoch_follows_jax(epochs, close_mosaic):
    """On the host path the loader's mosaic probability of every epoch is
    JAX's, `close_mosaic` larger than `epochs` included (JAX never reaches
    the epoch, so mosaic stays on throughout); the device's step threshold
    stays unset and the trainer's own arguments unchanged."""
    model = DetectionModel.from_npz(NPZ, device="cpu")
    rec = EpochRecorder()
    tr = Trainer(model, rec, overrides={"imgsz": S, "batch": 2, "workers": 1, "amp": False,
                                        "val": False, "save": False, "epochs": epochs,
                                        "close_mosaic": close_mosaic})
    assert tr.mosaic_off_step is None and rec.hyp is tr.args
    tr.train()
    assert rec.seen == jax_close_mosaic(epochs, close_mosaic) and tr.args["mosaic"] == 1.0


def test_port_imports_no_pil_or_albumentations():
    """The host pipeline draws on neither PIL nor `albumentations` (nor cv2,
    which `tests/test_torch_weights.py` bans with JAX): no module of the
    port imports them."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "mgdt_yolo_tpu_torch"
    files = sorted(root.rglob("*.py"))
    assert any(f.name == "imgproc.py" for f in files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("PIL", "albumentations", "cv2"), \
                    f"{path.relative_to(root.parent)} imports {name}"
