"""The port's dataset layer against the JAX package's, on the CPU: the
dataset YAML reader against PyYAML, the header reader, label verification
and its cache, `check_det_dataset`, `YOLODataset` items and the loader's
batches, on small YOLO-format datasets written here with cv2 (PNG, which
the port decodes on any machine; JPEG decoding needs the card's nvJPEG).

Tolerances, each with its reason:

* YAML, records, counts, drop sets, hashes, labels, `max_gt`: exact (the
  same parsing and numpy arithmetic);
* PNG pixels and the decoder's `load_batch` canvases: exact (lossless
  decode; the C++ resize is the JAX loader's, copied);
* boxes: 1e-4 px (float32 products in another order);
* pixels resized by the item path or letterboxed: cv2's INTER_LINEAR bits
  but one grey level in 0.5% of the values, the letterbox's limit
  (`tests/test_torch_letterbox.py`: cv2's scalar tail of a row rounds
  once more than its vector body).
"""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from mgdt_yolo_tpu.data import utils as JU
from mgdt_yolo_tpu.data.build import DataLoader as JaxDataLoader
from mgdt_yolo_tpu.data.dataset import YOLODataset as JaxYOLODataset
from mgdt_yolo_tpu.data.dataset import img2label_path as jax_img2label_path
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS
from mgdt_yolo_tpu_torch.data import utils as PU
from mgdt_yolo_tpu_torch.data.build import DataLoader
from mgdt_yolo_tpu_torch.data.dataset import YOLODataset, img2label_path
from mgdt_yolo_tpu_torch.engine.trainer import get_dataset
from mgdt_yolo_tpu_torch.utils.dataset_yaml import loads, yaml_load
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

BOX_ATOL = 1e-4


# ---------------------------------------------------------------------------
# datasets written for the tests
# ---------------------------------------------------------------------------

def scene(h, w, seed):
    """A seeded BGR scene: grey noise with coloured blocks."""
    rng = np.random.default_rng(seed)
    img = rng.integers(90, 150, (h, w, 3), dtype=np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, max(1, h - 4)), rng.integers(0, max(1, w - 4))
        img[y:y + max(2, h // 3), x:x + max(2, w // 4)] = rng.integers(0, 256, 3)
    return img


def label_rows(n, seed, nc=2):
    """`n` label rows `cls cx cy w h`, normalized, boxes inside the image."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.1, 0.4, (n, 2))
    c = rng.uniform(wh / 2, 1 - wh / 2)
    return [f"{int(rng.integers(0, nc))} {c[i, 0]:.6f} {c[i, 1]:.6f} {wh[i, 0]:.6f} "
            f"{wh[i, 1]:.6f}" for i in range(n)]


def write_dataset(root: Path, sizes, split="train", seed=0, nc=2, ext="png"):
    """images/<split>/im<i>.<ext> and labels/<split>/im<i>.txt for each
    (h, w) of `sizes`; returns the image directory."""
    img_dir, lab_dir = root / "images" / split, root / "labels" / split
    img_dir.mkdir(parents=True, exist_ok=True)
    lab_dir.mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(img_dir / f"im{i}.{ext}"), scene(h, w, seed * 1000 + i))
        rows = label_rows(1 + i % 3, seed * 1000 + i, nc)
        (lab_dir / f"im{i}.txt").write_text("\n".join(rows) + "\n")
    return img_dir


def write_yaml(root: Path, names=("piglet", "sow")) -> Path:
    text = (f"# a YOLO dataset\npath: {root}  # root\ntrain: images/train\n"
            f"val: images/val\ntest:  # none\n\nnames:\n" +
            "".join(f"  {i}: {n}\n" for i, n in enumerate(names)))
    p = root / "data.yaml"
    p.write_text(text)
    return p


def exif_app1(orientation: int) -> bytes:
    """A big-endian APP1 EXIF segment holding one Orientation tag."""
    ifd = struct.pack(">H", 1) + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + \
        struct.pack(">I", 0)
    payload = b"Exif\x00\x00" + b"MM\x00*" + struct.pack(">I", 8) + ifd
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def write_exif_jpeg(path: Path, img: np.ndarray, orientation: int):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    data = buf.tobytes()
    path.write_bytes(data[:2] + exif_app1(orientation) + data[2:])


# ---------------------------------------------------------------------------
# the dataset YAML reader
# ---------------------------------------------------------------------------

YAML_CASES = {
    "coco128": """# Ultralytics YOLO, AGPL-3.0 license
# COCO128 dataset https://www.kaggle.com/ultralytics/coco128 (first 128 images)
path: ../datasets/coco128  # dataset root dir
train: images/train2017  # train images (relative to 'path') 128 images
val: images/train2017  # val images (relative to 'path') 128 images
test:  # test images (optional)

# Classes
names:
  0: person
  1: bicycle
  2: 'traffic light'
  3: "fire # hydrant"

# Download script/URL (optional)
download: https://ultralytics.com/assets/coco128.zip
""",
    "inline-names": "path: /data/pigs\ntrain: train/images\nval: val/images\nnc: 2\n"
                    "names: ['piglet', \"sow\"]\n",
    "block-list": "train: a\nval: b\nnames:\n- piglet\n- sow\n- 'it''s'\n",
    "scalars": "names: [a]\nflag: yes\noff_: Off\nhex: 0x1F\noct: 017\nf: 1.5e+3\n"
               "s: 1e5\ninf: .inf\nneg: -.5\nnil: ~\nnull_: null\nq: \"tab\\tsep\\u00e9\"\n"
               "under: 1_000\nempty:\n",
    "download-block": "path: ../datasets/VOC\ntrain: images/train\nval: images/val\n"
                      "names:\n  0: aeroplane\n  1: bicycle\ndownload: |\n"
                      "  import os\n  print('x')  # a comment in the script\n\n"
                      "    indented\nafter: 3\n",
}


@pytest.mark.parametrize("name", sorted(YAML_CASES))
def test_yaml_reader_matches_pyyaml(name):
    text = YAML_CASES[name]
    assert loads(text) == yaml.safe_load(text)


UNSUPPORTED_YAML = ["a: &x 1", "a:\n  b:\n    c: 1", "a: {b: 1}", "a: [1, [2]]",
                    "a: >\n  x", "a: 1\na: 2", "a: 1:30", "a: !!str 1", "a: [1,\n 2]"]


@pytest.mark.parametrize("text", UNSUPPORTED_YAML)
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError, match="line"):
        loads(text)


def test_yaml_load_strips_as_jax(tmp_path):
    """The file reader removes what the JAX `yaml_load` removes first."""
    from mgdt_yolo_tpu.utils import yaml_load as jax_yaml_load
    p = tmp_path / "d.yaml"
    p.write_text("# \U0001F680 rocket\npath: x\x07y\nnames:\n  0: pig\x01let\n", "utf-8")
    assert yaml_load(p) == jax_yaml_load(p) == {"path": "xy", "names": {0: "piglet"}}


def test_check_det_dataset_matches_jax(tmp_path):
    for split in ("train", "val"):
        write_dataset(tmp_path, [(40, 50)], split)
    y = write_yaml(tmp_path)
    assert PU.check_det_dataset(y) == JU.check_det_dataset(y)
    assert PU.check_det_dataset(tmp_path / "images") == JU.check_det_dataset(
        tmp_path / "images")
    d = {"path": str(tmp_path), "train": "images/train", "nc": 3}
    assert PU.check_det_dataset(d) == JU.check_det_dataset(d)
    with pytest.raises(FileNotFoundError):
        PU.check_det_dataset(tmp_path / "missing.yaml")


# ---------------------------------------------------------------------------
# headers, verification and the label cache
# ---------------------------------------------------------------------------

def test_hash_and_label_paths_match_jax(tmp_path):
    img_dir = write_dataset(tmp_path, [(20, 30), (30, 20)])
    files = sorted(str(p) for p in img_dir.iterdir())
    labels = [img2label_path(f) for f in files]
    assert labels == [jax_img2label_path(f) for f in files]
    assert img2label_path("a/b.png") == jax_img2label_path("a/b.png") == "a/b.txt"
    assert PU.get_hash(labels + files) == JU.get_hash(labels + files)


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_exif_size_matches_jax(tmp_path, orientation):
    """The header's EXIF-corrected size is PIL's, as JAX reads it, for a
    JPEG of each orientation and a PNG and a BMP."""
    from PIL import Image
    img = scene(30, 50, orientation)
    write_exif_jpeg(tmp_path / "a.jpg", img, orientation)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    for name in ("a.jpg", "a.png", "a.bmp"):
        with Image.open(tmp_path / name) as im:
            assert PU.exif_size(tmp_path / name) == JU.exif_size(im), name


def _verify_cases(root: Path):
    """A tmp dataset holding each case of the issue's list, with its
    expected fate; returns (image files, label files)."""
    img_dir, lab_dir = root / "images", root / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    good = "0 0.5 0.5 0.2 0.3\n1 0.25 0.3 0.1 0.1\n"
    cases = {
        "ok": (scene(40, 60, 1), good),
        "corrupt": (None, good),                       # not an image at all
        "missing_label": (scene(40, 60, 2), None),
        "empty_label": (scene(40, 60, 3), ""),
        "duplicates": (scene(40, 60, 4), good + "0 0.5 0.5 0.2 0.3\n"),
        "polygon": (scene(40, 60, 5), "1 0.1 0.1 0.4 0.1 0.4 0.5 0.1 0.5\n"
                                      "0 0.5 0.5 0.9 0.6 0.7 0.9 0.6 0.8\n"),
        "class_ge_nc": (scene(40, 60, 6), "5 0.5 0.5 0.2 0.2\n"),
        "not_normalized": (scene(40, 60, 7), "0 1.5 0.5 0.2 0.2\n"),
        "negative": (scene(40, 60, 8), "0 0.5 -0.5 0.2 0.2\n"),
        "six_columns": (scene(40, 60, 9), "0 0.5 0.5 0.2 0.2 0.9\n"),
        "tiny": (scene(9, 40, 10), good),
        "exif_rotated": (scene(30, 50, 11), good),
    }
    ims, labs = [], []
    for name, (img, text) in cases.items():
        ext = "jpg" if name in ("exif_rotated", "corrupt") else "png"
        p = img_dir / f"{name}.{ext}"
        if img is None:
            p.write_bytes(b"\xff\xd8 not a JPEG at all")
        elif name == "exif_rotated":
            write_exif_jpeg(p, img, 6)
        else:
            cv2.imwrite(str(p), img)
        lp = lab_dir / f"{name}.txt"
        if text is not None:
            lp.write_text(text)
        ims.append(str(p))
        labs.append(str(lp))
    return ims, labs


def _same_records(got, want):
    assert [r["im_file"] for r in got] == [r["im_file"] for r in want]
    for a, b in zip(got, want):
        assert tuple(a["shape"]) == tuple(b["shape"]), a["im_file"]
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_array_equal(a["xywh"], b["xywh"])
        assert a["cls"].dtype == b["cls"].dtype and a["xywh"].dtype == b["xywh"].dtype


@pytest.mark.parametrize("num_cls", [None, 2])
def test_verify_image_label_matches_jax(tmp_path, num_cls):
    """Record by record: the record (or the drop) and the four counts."""
    ims, labs = _verify_cases(tmp_path)
    dropped = set()
    for im, lb in zip(ims, labs):
        got, want = PU.verify_image_label(im, lb, num_cls), JU.verify_image_label(im, lb,
                                                                                 num_cls)
        assert got[1:5] == want[1:5], im
        assert (got[0] is None) == (want[0] is None), (im, got[5], want[5])
        if got[0] is None:
            dropped.add(Path(im).stem)
        else:
            _same_records([got[0]], [want[0]])
        assert bool(got[5]) == bool(want[5]), (got[5], want[5])
    want_dropped = {"corrupt", "not_normalized", "negative", "six_columns", "tiny"}
    assert dropped == want_dropped | ({"class_ge_nc"} if num_cls else set())


def test_scan_labels_and_cache_cross_read(tmp_path):
    """The scan's records and the cache's counts equal JAX's; a cache
    written by either package is read by the other (a label rewritten
    without changing its size leaves the hash, so the cached record is the
    one returned)."""
    ims, labs = _verify_cases(tmp_path)
    jc, pc = tmp_path / "jax.cache", tmp_path / "port.cache"
    want, got = JU.scan_labels(ims, labs, jc), PU.scan_labels(ims, labs, pc)
    _same_records(got, want)
    jd, pd = (np.load(str(c), allow_pickle=True).item() for c in (jc, pc))
    assert pd["results"] == jd["results"] == (9, 1, 1, 5, 12)
    assert pd["hash"] == jd["hash"] and pd["version"] == jd["version"] == PU.CACHE_VERSION
    ok = Path(labs[0])
    ok.write_text(ok.read_text().replace("0 0.5", "1 0.5"))  # same size, same hash
    for reader, cache in ((PU.scan_labels, jc), (JU.scan_labels, pc)):
        back = reader(ims, labs, cache)
        _same_records(back, want)  # the cached records, not a rescan
    rescan = PU.scan_labels(ims, labs, tmp_path / "new.cache")
    assert rescan[0]["cls"][0] == 1


def test_truncated_jpeg_is_logged_and_left_as_it_is(tmp_path, caplog):
    """The port does not rewrite a JPEG without its end marker, as JAX
    does through PIL: it logs it and keeps the file."""
    p = tmp_path / "images" / "t.jpg"
    p.parent.mkdir()
    ok, buf = cv2.imencode(".jpg", scene(40, 60, 3))
    data = buf.tobytes()[:-200]
    p.write_bytes(data)
    rec, nm, nf, ne, nc, msg = PU.verify_image_label(str(p), str(tmp_path / "t.txt"))
    assert rec is not None and (nm, nf, ne, nc) == (1, 0, 0, 0)
    assert "corrupt JPEG" in msg and p.read_bytes() == data


# ---------------------------------------------------------------------------
# YOLODataset and the loader
# ---------------------------------------------------------------------------

SIZES = [(48, 64), (80, 60), (100, 100), (37, 53), (64, 64), (120, 70), (60, 90),
         (96, 72)]


def _items_equal(got, want):
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=BOX_ATOL)
    assert got["path"] == want["path"] and tuple(got["ori_shape"]) == tuple(want["ori_shape"])


@pytest.mark.parametrize("kw", [{}, {"fraction": 0.5}, {"single_cls": True},
                                {"cache": "ram"}, {"cache": "disk"}],
                         ids=["plain", "fraction", "single_cls", "ram", "disk"])
def test_yolo_dataset_items_match_jax(tmp_path, kw):
    img_dir = write_dataset(tmp_path, SIZES)
    ours = YOLODataset(str(img_dir), **kw)
    (tmp_path / "labels" / "train.cache").unlink()  # each package scans for itself
    theirs = JaxYOLODataset(str(img_dir), imgsz=64, **kw)
    assert len(ours) == len(theirs) == (4 if kw.get("fraction") else len(SIZES))
    assert ours.im_files == theirs.im_files and ours.max_labels() == theirs.max_labels()
    for i in range(len(ours)):
        for _ in range(2):  # the second read goes through the cache
            _items_equal(ours[i], theirs[i])
    if kw.get("single_cls"):
        assert all((ours[i]["cls"] == 0).all() for i in range(len(ours)))
    if kw.get("cache") == "disk":
        assert all(Path(f).with_suffix(".npy").is_file() for f in ours.im_files)


def test_unsupported_formats_raise(tmp_path):
    img_dir = write_dataset(tmp_path, SIZES[:2])
    cv2.imwrite(str(img_dir / "x.bmp"), scene(20, 20, 0))
    with pytest.raises(native.UnsupportedFormat, match="bmp"):
        YOLODataset(str(img_dir))


def _close_pixels(got, want, what):
    """cv2's bits, but one grey level in at most 0.5% of the values."""
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (what, d.max(), (d > 0).mean())


def _batches_equal(got, want, exact: bool):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) - {"metas"} | ({"metas"} if "metas" in g else set())
        for k in ("gt_labels", "mask_gt", "img_hw"):
            if k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_allclose(g["gt_bboxes"], w["gt_bboxes"], rtol=0, atol=BOX_ATOL)
        if exact:
            np.testing.assert_array_equal(g["img"], w["img"])
        else:
            _close_pixels(g["img"], w["img"], "img")
        if "metas" in w:
            for a, b in zip(g["metas"], w["metas"]):
                assert tuple(a["ori_shape"]) == tuple(b["ori_shape"])
                assert a["ratio_pad"] == b["ratio_pad"] and a["path"] == b["path"]


@pytest.mark.parametrize("ingest", ["native", "items"])
def test_train_batches_match_jax(tmp_path, ingest):
    """Device-augment train batches at 64 px (the raw, unaugmented canvases
    the trainer augments on the device), two epochs: through the decoder's
    `load_batch` against JAX's native loader (exact), and through the item
    path (a RAM cache interposed) against JAX's cv2 path."""
    img_dir = write_dataset(tmp_path, SIZES)
    cache = "ram" if ingest == "items" else False
    ours = DataLoader(YOLODataset(str(img_dir), cache=cache), 3, 64, seed=4,
                      train=True, device_augment=True, hyp=TRAIN_DEFAULTS, workers=2)
    theirs = JaxDataLoader(JaxYOLODataset(str(img_dir), imgsz=64, cache=cache), 3, 64,
                           train=True, seed=4, workers=2, device_augment=True)
    assert ours.native_eligible() == (ingest == "native") == theirs._native_eligible()
    assert ours.max_gt == theirs.max_gt == 16 and len(ours) == len(theirs) == 2
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        _batches_equal(list(ours), list(theirs), exact=ingest == "native")


def test_val_batches_match_jax(tmp_path):
    """Letterboxed validation batches (`scaleup=False`: pad only for the
    small images, cv2's resize for those larger than 64), the short last
    batch kept, `metas` with the ratio, pads and path."""
    img_dir = write_dataset(tmp_path, SIZES)
    ours = DataLoader(YOLODataset(str(img_dir)), 3, 64, train=False)
    theirs = JaxDataLoader(JaxYOLODataset(str(img_dir), imgsz=64), 3, 64, train=False)
    assert ours.max_gt == theirs.max_gt == 8 and len(ours) == len(theirs) == 3
    _batches_equal(list(ours), list(theirs), exact=False)


@pytest.mark.parametrize("hyp", [{}, {"mosaic9": 0.5}, {"mixup": 0.1},
                                 {"mosaic9": 0.5, "mixup": 0.1}],
                         ids=["mosaic", "mosaic9", "mixup", "both"])
def test_max_gt_rule_matches_jax(tmp_path, hyp):
    from types import SimpleNamespace
    img_dir = write_dataset(tmp_path, SIZES[:3])
    ds, jds = YOLODataset(str(img_dir)), JaxYOLODataset(str(img_dir))
    a = {**TRAIN_DEFAULTS, **hyp}
    for train in (True, False):
        got = DataLoader(ds, 2, 64, train=train, hyp=a).max_gt
        want = JaxDataLoader(jds, 2, 64, train=train, hyp=SimpleNamespace(**a)).max_gt
        assert got == want


def test_trainer_dataset_from_yaml_sets_names(tmp_path):
    """`get_dataset` resolves the YAML's splits, sets its names on the
    model and refuses a model of another class count; `single_cls`,
    `fraction` (train split only) and `cache` reach the dataset."""
    from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
    write_dataset(tmp_path, SIZES, "train")
    write_dataset(tmp_path, SIZES[:3], "val", seed=1)
    y = write_yaml(tmp_path)
    model = DetectionModel("yolov8.yaml", nc=2, device="cpu")
    a = {**TRAIN_DEFAULTS, "data": str(y), "imgsz": 64, "single_cls": True, "fraction": 0.5,
         "cache": "ram"}
    train, val = get_dataset(a, True, model), get_dataset(a, False, model)
    assert model.names == {0: "piglet", 1: "sow"}
    assert len(train) == 4 and len(val) == 3 and val.im_files[0].endswith("val/im0.png")
    assert train.single_cls and train.cache == "ram" and (train[0]["cls"] == 0).all()
    with pytest.raises(ValueError, match="nc=3"):
        get_dataset(a, True, DetectionModel("yolov8.yaml", nc=3, device="cpu"))


# ---------------------------------------------------------------------------
# the validator as a standalone entry point
# ---------------------------------------------------------------------------

# val images whose letterbox to 128 px is exact (pad only, or 2x down), so
# the model is what the two validators compare
VAL_DISK_SIZES = [(96, 96), (128, 96), (256, 192), (64, 128), (96, 72), (192, 256),
                  (120, 128), (80, 100)]


def test_standalone_validator_on_data_matches_jax(tmp_path):
    """`DetectionValidator({"data": yaml})(model)` validates on the YAML's
    val split as the JAX validator does given `data=` alone: the same
    per-image detections within the predictor's limits (boxes 1e-3 px, scores
    1e-5), labels exact, metrics to 1e-6."""
    import jax
    from mgdt_yolo_tpu.cfg import get_cfg
    from mgdt_yolo_tpu.engine.validator import DetectionValidator as JaxValidator
    from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
    from mgdt_yolo_tpu_torch.engine.validator import DetectionValidator
    from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
    from test_torch_train import NPZ, _nest, _npz
    write_dataset(tmp_path, SIZES[:2], "train")
    write_dataset(tmp_path, VAL_DISK_SIZES, "val", seed=7)
    y = write_yaml(tmp_path)
    args = {"data": str(y), "imgsz": 128, "batch": 8}
    jm = JaxDetectionModel("mspa_c2f_gd_tood_yolov8.yaml")
    jm.set_deform_semantics("windowed")
    jv = JaxValidator(args=get_cfg(overrides={**args, "plots": False}))
    want = jv(jm, jax.tree.map(np.asarray, _nest(_npz(NPZ))))
    pv = DetectionValidator({**args, "amp": False})
    got = pv(DetectionModel.from_npz(NPZ, device="cpu"))
    assert len(pv.per_image_preds) == len(jv._per_image_preds) == len(VAL_DISK_SIZES)
    total = 0
    for a, b in zip(pv.per_image_preds, jv._per_image_preds):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 5], b[:, 5])
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-5)
        total += len(a)
    for (ga, ca), (gb, cb) in zip(pv.per_image_gts, jv._per_image_gts):
        np.testing.assert_allclose(ga, gb, rtol=0, atol=BOX_ATOL)
        np.testing.assert_array_equal(ca, cb)
    for k in ("precision", "recall", "map50", "map", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert total > 0
