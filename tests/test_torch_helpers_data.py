"""The JAX package's data, file, check and naming helpers in the port,
against JAX on the CPU: `polygon2mask` / `polygons2masks` (JAX's are
cv2.fillPoly and cv2's nearest resize; the port's are its own rasteriser,
`utils/draw.fill_poly`, and `data/imgproc.resize_nearest`, with no cv2),
`convert_coco`, the `files` helpers, `check_suffix`, `check_requirements`,
`check_bf16`, the `utils` constants and `colorstr`, `guess_model_scale`
and `yaml_model_load`, RT-DETR's `square_letterbox` and
`postprocess_queries`, and the one-call `device_augment`,
`build_dataloader`, `native.available` and `TwoWayBlock` names.

Masks, label files, constants and configs must equal JAX's exactly; the
letterbox and the query rows too (the same numpy arithmetic). The import
scan of `tests/test_torch_weights.py` must reach every new module.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import mgdt_yolo_tpu.utils as jutils
from mgdt_yolo_tpu.data import utils as jdata
from mgdt_yolo_tpu.nn import tasks as jtasks
from mgdt_yolo_tpu.utils import checks as jchecks
from mgdt_yolo_tpu.utils import files as jfiles
from mgdt_yolo_tpu.vit.rtdetr import val as jrtval
import mgdt_yolo_tpu_torch.utils as putils
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.data import build, utils as pdata
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset
from mgdt_yolo_tpu_torch.nn import tasks as ptasks
from mgdt_yolo_tpu_torch.ops import device_augment as da
from mgdt_yolo_tpu_torch.utils import checks as pchecks
from mgdt_yolo_tpu_torch.utils import files as pfiles
from mgdt_yolo_tpu_torch.vit.rtdetr import val as prtval
from mgdt_yolo_tpu_torch.vit.sam import modules as sam_modules
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_weights import ROOT, _imports


# ---------------------------------------------------------------------------
# polygon masks
# ---------------------------------------------------------------------------

def _polygons(kind, rng, h, w):
    """Seeded polygons of one kind, float (x, y) points as labels give them."""
    if kind == "convex":
        c = rng.uniform(0.2, 0.8, 2) * (w, h)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        r = min(h, w) * 0.3
        return [np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)]
    if kind == "non_convex":  # a star and an L
        c = rng.uniform(0.3, 0.7, 2) * (w, h)
        ang = np.linspace(0, 2 * np.pi, 14, endpoint=False)
        r = np.where(np.arange(14) % 2, 0.12, 0.35) * min(h, w)
        ell = np.array([[2, 2], [30, 2], [30, 9], [9, 9], [9, 40], [2, 40]], float) + 0.7
        return [np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1), ell]
    if kind == "self_intersecting":  # random points: crossings and holes
        return [rng.uniform(-0.1, 1.1, (k, 2)) * (w, h) for k in (7, 12)]
    raise KeyError(kind)


@pytest.mark.parametrize("ratio", [1, 4])
@pytest.mark.parametrize("kind", ["convex", "non_convex", "self_intersecting"])
def test_polygon_masks_are_jaxs(kind, ratio):
    rng = np.random.default_rng({"convex": 0, "non_convex": 1, "self_intersecting": 2}[kind])
    for h, w in ((64, 96), (81, 57)):
        polys = _polygons(kind, rng, h, w)
        got = pdata.polygon2mask((h, w), polys, 1, ratio)
        want = jdata.polygon2mask((h, w), polys, 1, ratio)
        assert got.dtype == want.dtype == np.uint8 and got.any()
        np.testing.assert_array_equal(got, want)
        got = pdata.polygons2masks((h, w), polys, 255, ratio)
        np.testing.assert_array_equal(got, jdata.polygons2masks((h, w), polys, 255, ratio))
    np.testing.assert_array_equal(pdata.polygons2masks((64, 96), [], 1, ratio),
                                  jdata.polygons2masks((64, 96), [], 1, ratio))


# ---------------------------------------------------------------------------
# convert_coco
# ---------------------------------------------------------------------------

def _coco(tmp_path):
    rng = np.random.default_rng(3)
    images = [{"id": i, "file_name": f"img_{i:03d}.jpg", "width": 640 - 32 * i,
               "height": 480 + 16 * i} for i in range(4)]
    cats = [{"id": cid, "name": f"c{cid}"} for cid in (7, 3, 11)]
    anns = []
    for k in range(12):
        im = images[k % 3]  # image 3 has no annotation
        x, y = rng.uniform(0, 300, 2)
        bw, bh = rng.uniform(5, 200, 2)
        seg = [float(v) for v in rng.uniform(0, 300, 10)]
        anns.append({"id": k, "image_id": im["id"], "category_id": cats[k % 3]["id"],
                     "bbox": [x, y, bw, bh], "segmentation": [seg], "iscrowd": int(k == 5)})
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": images, "categories": cats, "annotations": anns}))
    return path


@pytest.mark.parametrize("use_segments", [False, True])
def test_convert_coco_writes_jaxs_files(tmp_path, use_segments):
    src = _coco(tmp_path)
    got = pdata.convert_coco(src, tmp_path / "port", use_segments)
    want = jdata.convert_coco(src, tmp_path / "jax", use_segments)
    names = sorted(p.name for p in Path(want).iterdir())
    assert sorted(p.name for p in Path(got).iterdir()) == names and len(names) == 3
    for n in names:
        assert (Path(got) / n).read_text() == (Path(want) / n).read_text()


# ---------------------------------------------------------------------------
# files, checks, constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [pfiles, jfiles], ids=["port", "jax"])
def test_file_helpers(mod, tmp_path):
    """`tests/test_utils_misc.py::TestFilesUtils` run on both packages, with
    the port's own checkpoint name beside JAX's."""
    f = tmp_path / "weights" / "last.ckpt"
    f.parent.mkdir()
    f.write_bytes(b"x" * 2048)
    assert mod.file_age(f) == 0
    assert mod.file_date(f) == jfiles.file_date(f) and len(mod.file_date(f).split("-")) == 3
    assert mod.file_size(f) == 2048 / 2 ** 20 and mod.file_size(tmp_path) >= mod.file_size(f)
    assert mod.file_size(tmp_path / "missing") == 0.0
    assert mod.get_latest_run(str(tmp_path)).endswith("last.ckpt")
    cwd = os.getcwd()
    with mod.WorkingDirectory(tmp_path):
        assert os.getcwd() == str(tmp_path)
    assert os.getcwd() == cwd
    d = tmp_path / "with space.txt"
    d.write_text("hi")
    with mod.spaces_in_path(d) as p:
        assert " " not in str(p) and p.read_text() == "hi"
        p.write_text("changed")
    assert d.read_text() == "changed" and not (tmp_path / "with_space.txt").exists()
    if mod is pfiles:  # the port's checkpoints, not their resume states
        run = tmp_path / "run2" / "weights"
        run.mkdir(parents=True)
        np.savez(run / "last.npz", a=np.zeros(1))
        np.savez(run / "last_resume.npz", a=np.zeros(1))
        assert pfiles.get_latest_run(str(tmp_path)) == str(run / "last.npz")
        assert pfiles.get_latest_run(str(tmp_path / "nothing")) == ""


def test_checks_match_jax():
    for file, suffix in (("a.yaml", (".yaml",)), ("a.YML", (".yml", ".yaml")), ("noext", ".pt")):
        pchecks.check_suffix(file, suffix)
        jchecks.check_suffix(file, suffix)
    for mod in (pchecks, jchecks):
        with pytest.raises(ValueError, match="unsupported suffix .pt"):
            mod.check_suffix("w.pt", ".npz", msg="model ")
    for req in (["numpy>=1.0", "json"], "numpy", ["numpy", "not_a_package_xyz==1"]):
        assert pchecks.check_requirements(req, install=True) == jchecks.check_requirements(req)
    assert pchecks.check_bf16("cpu") is True and jchecks.check_bf16() is True


def test_utils_constants_and_colorstr():
    assert putils.DEFAULT_CFG_DICT == jutils.DEFAULT_CFG_DICT
    assert list(putils.DEFAULT_CFG_KEYS) == list(jutils.DEFAULT_CFG_KEYS)
    assert dict(putils.DEFAULT_CFG) == dict(jutils.DEFAULT_CFG) and putils.DEFAULT_CFG.get("iou")
    assert putils.DEFAULT_CFG_PATH.is_file()
    assert putils.NUM_THREADS == jutils.NUM_THREADS and putils.RANK == jutils.RANK
    assert putils.USER_CONFIG_DIR == jutils.USER_CONFIG_DIR
    assert putils.SETTINGS_YAML == jutils.SETTINGS_YAML
    assert putils.LOGGING_NAME == "mgdt_yolo_tpu_torch"
    for args in (("hello",), ("red", "underline", "x"), ("green", 3)):
        assert putils.colorstr(*args) == jutils.colorstr(*args)


@pytest.mark.parametrize("name", ["yolov8s.yaml", "mspa_c2f_gd_tood_yolov8.yaml",
                                  "yolov5n-p6.yaml", "rtdetr-l.yaml", "yolov8m-seg.yaml"])
def test_yaml_model_load_and_scale_match_jax(name):
    assert ptasks.guess_model_scale(name) == jtasks.guess_model_scale(name)
    assert ptasks.yaml_model_load(name) == jtasks.yaml_model_load(name)
    assert ptasks.guess_model_scale(f"runs/{name}") == jtasks.guess_model_scale(f"runs/{name}")


def test_yaml_model_load_of_an_unknown_name_raises_as_jax():
    for fn in (ptasks.yaml_model_load, jtasks.yaml_model_load):
        with pytest.raises(FileNotFoundError):
            fn("no_such_model.yaml")


# ---------------------------------------------------------------------------
# RT-DETR's validator helpers, the engines' other names
# ---------------------------------------------------------------------------

def test_rtdetr_val_helpers_match_jax():
    img = np.random.default_rng(4).integers(0, 256, (75, 131, 3), dtype=np.uint8)
    (got, gmeta), (want, wmeta) = prtval.square_letterbox(img, 96), jrtval.square_letterbox(img, 96)
    np.testing.assert_array_equal(got, want)
    assert gmeta == wmeta
    rng = np.random.default_rng(5)
    bb = rng.uniform(0.1, 0.9, (30, 4)).astype(np.float32)
    sc = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    for conf in (0.001, 0.8):
        got, want = prtval.postprocess_queries(bb, sc, conf), jrtval.postprocess_queries(bb, sc, conf)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_device_augment_is_draws_then_apply():
    ds = SyntheticDetectionDataset(n=4, imgsz=64, nc=2)
    loader = build.build_dataloader(ds, 4, 64, train=True, device_augment=True, seed=1)
    ref = build.DataLoader(ds, 4, 64, seed=1, train=True, device_augment=True)
    raw, raw2 = next(iter(loader)), next(iter(ref))
    assert loader.device_augment and loader.batch_size == 4
    for k in raw:
        np.testing.assert_array_equal(np.asarray(raw[k]), np.asarray(raw2[k]))
    batch = {k: torch.from_numpy(np.asarray(raw[k])) for k in
             ("img", "img_hw", "gt_bboxes", "gt_labels", "mask_gt")}
    got = da.device_augment(batch, torch.Generator().manual_seed(3), 64)
    want = da.apply_augment(batch, da.augment_draws(4, 64, torch.Generator().manual_seed(3)), 64)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_other_names():
    assert native.available() is True
    assert sam_modules.TwoWayBlock is sam_modules.TwoWayAttentionBlock


NEW_MODULES = ("utils/torch_utils.py", "utils/files.py", "utils/__init__.py", "utils/checks.py",
               "ops/nms.py", "ops/boxes.py", "ops/deform.py", "utils/tal.py", "nn/tasks.py",
               "data/utils.py", "engine/exporter.py", "engine/trainer.py", "vit/rtdetr/val.py")


def test_import_scan_reaches_the_new_modules():
    """`test_torch_weights.test_port_imports_no_jax_and_nothing_of_the_jax_package`
    scans every module of the package; the ones this slice adds or extends
    are among them and import nothing it bans."""
    scanned = {p.relative_to(ROOT / "mgdt_yolo_tpu_torch").as_posix()
               for p in (ROOT / "mgdt_yolo_tpu_torch").rglob("*.py")}
    banned = ("jax", "jaxlib", "flax", "optax", "mgdt_yolo_tpu", "yaml", "cv2", "matplotlib")
    for rel in NEW_MODULES:
        assert rel in scanned, rel
        for name in _imports(ROOT / "mgdt_yolo_tpu_torch" / rel):
            assert name.split(".")[0] not in banned, (rel, name)
