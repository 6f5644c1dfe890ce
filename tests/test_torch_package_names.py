"""The port's package-level names against the JAX package's, on the CPU.

* Each JAX package's `__init__.py` is read with `ast` (nothing of it is
  imported): the names it defines and those it imports from the JAX
  package's own modules, with the names of its `__all__` (the top level's
  `YOLO` comes through its `__getattr__`). Imports from outside the package
  (modules, `typing` names, `Path`) are not its API, and `NOT_TO_PORT`
  (ROADMAP.md, "Not to port") are left out. Every other name imports from
  the port's package of the same path and is the same object as the
  port's module that holds it: the port's module at the path JAX imports
  it from, or `ELSEWHERE` where the port keeps it in another module. Where
  JAX has an `__all__`, the port's covers it; `from <package> import *`
  gives every name.
* `load_source` against JAX's, on a directory of jpg, png and bmp scenes
  and on a numpy array: the same paths in the same order and the same BGR
  pixels, exact (lossless files, as `tests/test_torch_dataset.py` holds
  the decoder). The port reads JPEG with nvJPEG only: without a CUDA
  device the JPEG is skipped with the decoder's warning; with one, its
  pixels are held to cv2's at `chip_smoke.py` phase 15's limits (max 3
  grey levels, mean below 0.1: nvJPEG's IDCT is not libjpeg's).
* `data.dataset.SyntheticDetectionDataset` is `data.synthetic`'s.
* Importing the top level and `nn.modules` (and using a module class)
  loads neither the facade (`engine.model`) nor the trainer, in a fresh
  process.
"""
import ast
import importlib
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.predictor import load_source as jax_load_source
from mgdt_yolo_tpu_torch.engine.predictor import load_source
from test_torch_dataset import scene
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("", "cfg", "data", "engine", "native", "nn", "nn.modules", "ops", "tracker",
            "utils", "vit", "vit.rtdetr", "vit.sam")
# ROADMAP.md, "Not to port": JAX's train state, its graph model, NAS
NOT_TO_PORT = {"TrainState", "GraphModel", "NAS"}
# names the port keeps in another module than the one JAX's `__init__.py`
# imports them from, or defines them in: {package: {name: port module}}
ELSEWHERE = {
    "": {"YOLO": "engine.model"},
    "utils": {**dict.fromkeys(("LOGGER", "set_logging", "yaml_save", "yaml_print",
                               "get_settings", "set_settings", "increment_path"),
                              "utils.settings"),
              "yaml_load": "utils.dataset_yaml", "SimpleClass": "engine.results"},
}


def _jax_names(package: str):
    """(the public names JAX's `__init__.py` of `package` binds from its own
    package, {name: its module relative to the JAX package, where it
    imports it}, its `__all__` or None)."""
    path = ROOT / "mgdt_yolo_tpu" / package.replace(".", "/") / "__init__.py"
    names, sources, all_ = [], {}, None
    parts = package.split(".") if package else []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = parts[:len(parts) - node.level + 1]
            module = ".".join([*base, *(node.module or "").split(".")]).strip(".")
            for a in node.names:
                names.append(a.asname or a.name)
                sources[a.asname or a.name] = module
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.append(t.id)
                    if t.id == "__all__":
                        all_ = ast.literal_eval(node.value)
    public = [n for n in dict.fromkeys(names + list(all_ or ())) if not n.startswith("_")
              or n == "__version__"]
    return [n for n in public if n not in NOT_TO_PORT and n != "__all__"], sources, all_


def _port(package: str):
    return importlib.import_module("mgdt_yolo_tpu_torch" + (f".{package}" if package else ""))


@pytest.mark.parametrize("package", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_every_jax_package_name_imports_from_the_port(package):
    """Every public name of JAX's `__init__.py` (less "Not to port") is the
    port's object of the same name, in `__all__` and `import *` too."""
    names, sources, jax_all = _jax_names(package)
    assert names, package
    port = _port(package)
    for name in names:
        assert hasattr(port, name), f"{package or 'top'}: {name} does not import"
        src = ELSEWHERE.get(package, {}).get(name) or sources.get(name)
        if src is not None:
            want = getattr(_port(src), name)
            assert getattr(port, name) is want, f"{package}.{name} is not {src}.{name}"
        assert name in dir(port), name
    if jax_all is not None:
        missing = set(jax_all) - NOT_TO_PORT - set(port.__all__)
        assert not missing, f"{package or 'top'}: __all__ lacks {sorted(missing)}"
    star = {}
    exec(f"from {port.__name__} import *", star)
    assert set(names) <= set(star), sorted(set(names) - set(star))
    print(f"{package or 'top'}: {len(names)} names")


def test_reexports_are_the_modules_objects():
    """Where a name could be another object: the letterbox is
    `data.augment`'s (not `data.build`'s), the `cfg` and `utils` names are
    those the port keeps in `utils`, the logger is the package's, and a
    "Not to port" name does not import."""
    import mgdt_yolo_tpu_torch as top
    from mgdt_yolo_tpu_torch import cfg, data, native, utils
    from mgdt_yolo_tpu_torch.data import augment, build
    from mgdt_yolo_tpu_torch.engine.model import YOLO
    from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
    from mgdt_yolo_tpu_torch.utils import dataset_yaml, settings
    assert data.letterbox is augment.letterbox is not build.letterbox
    assert cfg.yaml_load is utils.yaml_load is dataset_yaml.yaml_load
    assert cfg.DEFAULT_CFG_DICT is utils.DEFAULT_CFG_DICT and cfg.colorstr is utils.colorstr
    assert native.LOGGER is utils.LOGGER is settings.LOGGER is logging.getLogger(
        "mgdt_yolo_tpu_torch")
    assert top.DetectionModel is DetectionModel and top.YOLO is YOLO
    with pytest.raises(AttributeError, match="no attribute 'TrainState'"):
        importlib.import_module("mgdt_yolo_tpu_torch.engine").TrainState


def test_synthetic_dataset_is_importable_where_jax_defines_it():
    from mgdt_yolo_tpu_torch.data import SyntheticDetectionDataset as from_package
    from mgdt_yolo_tpu_torch.data.dataset import SyntheticDetectionDataset
    from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset as defined
    assert SyntheticDetectionDataset is defined is from_package


def test_load_source_matches_jax(tmp_path, caplog):
    """A directory of jpg, png and bmp scenes (one in a subdirectory) and a
    numpy array: JAX's items and the port's, paths and pixels."""
    d = tmp_path / "scenes"
    (d / "sub").mkdir(parents=True)
    files = {"a.png": (40, 52), "b.bmp": (33, 47), "c.jpg": (48, 64), "sub/d.png": (21, 30),
             "sub/e.bmp": (64, 16)}
    for i, (name, (h, w)) in enumerate(files.items()):
        cv2.imwrite(str(d / name), scene(h, w, i))
    (d / "notes.txt").write_text("not an image")
    want = jax_load_source(str(d))
    with caplog.at_level(logging.WARNING):
        got = load_source(d)
    jpegs = [w["path"] for w in want if w["path"].endswith(".jpg")]
    assert len(want) == len(files) and jpegs == [str(d / "c.jpg")]
    if not torch.cuda.is_available():
        assert any("c.jpg" in r.getMessage() and "CUDA" in r.getMessage()
                   for r in caplog.records)
        want = [w for w in want if w["path"] not in jpegs]
    assert [g["path"] for g in got] == [w["path"] for w in want]
    for g, w in zip(got, want):
        if g["path"] in jpegs:
            diff = np.abs(g["img"].astype(np.int16) - w["img"].astype(np.int16))
            assert diff.max() <= 3 and diff.mean() < 0.1, (diff.max(), diff.mean())
        else:
            np.testing.assert_array_equal(g["img"], w["img"], err_msg=g["path"])
        assert (g["frame_idx"], g["is_video"]) == (w["frame_idx"], w["is_video"]) == (0, False)
    arr = scene(37, 41, 9)
    got, want = load_source(arr), jax_load_source(arr)
    assert [g["path"] for g in got] == [w["path"] for w in want] == ["array0.jpg"]
    np.testing.assert_array_equal(got[0]["img"], want[0]["img"])


def test_packages_import_without_the_engine():
    """A fresh process: the top level, `nn.modules` with a module class,
    `ops`, `data`, `cfg` and `utils` import neither the facade nor the
    trainer."""
    code = ("import json, sys, mgdt_yolo_tpu_torch, mgdt_yolo_tpu_torch.nn.modules as M\n"
            "import mgdt_yolo_tpu_torch.ops, mgdt_yolo_tpu_torch.data\n"
            "import mgdt_yolo_tpu_torch.cfg, mgdt_yolo_tpu_torch.utils\n"
            "M.Conv, M.TOODHead\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.startswith('mgdt_yolo_tpu_torch'))))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mgdt_yolo_tpu_torch.nn.modules.conv" in loaded
    assert not loaded & {"mgdt_yolo_tpu_torch.engine.model", "mgdt_yolo_tpu_torch.engine.trainer"}
