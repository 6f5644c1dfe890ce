"""Carrying the committed JAX weights into the port, the semantics pin, the
port's independence from JAX, and its default device."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mgdt_yolo_tpu_torch.data.synthetic import synthetic_batch
from mgdt_yolo_tpu_torch.device import resolve_device
from mgdt_yolo_tpu_torch.engine.predictor import predict
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.weights import (load_jax_variables, load_state,
                                         read_semantics, translate)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "weights" / "mgdt_n_synth.npz"


def _npz():
    with np.load(str(NPZ)) as f:
        return {k: f[k] for k in f.files}


def test_every_key_lands_and_every_parameter_is_filled():
    flat = _npz()
    colls = [k.split(".", 1)[0] for k in flat]
    assert (colls.count("params"), colls.count("batch_stats")) == (218, 94)
    state = load_jax_variables(flat)
    assert len(state) == 312
    model = DetectionModel(device="cpu")
    own = model.state_dict()
    expected = {k for k in own if not k.endswith("num_batches_tracked")}
    assert set(state) == expected
    for k, v in state.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    load_state(model, state)
    for k, v in model.state_dict().items():
        if k in state:
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def test_nested_tree_loads_like_flat():
    flat = _npz()
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    a, b = load_jax_variables(flat), load_jax_variables(tree)
    assert list(a) == list(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_layouts():
    conv = np.arange(3 * 3 * 4 * 5, dtype=np.float32).reshape(3, 3, 4, 5)
    name, t = translate("params.model_0.conv.kernel", conv)
    assert name == "model_0.conv.weight"
    np.testing.assert_array_equal(t.numpy(), conv.transpose(3, 2, 0, 1))
    dw = np.ones((7, 7, 1, 96), np.float32)
    assert tuple(translate("params.b.dwconv.kernel", dw)[1].shape) == (96, 1, 7, 7)
    dense = np.arange(12, dtype=np.float32).reshape(3, 4)
    name, t = translate("params.b.pwconv1.kernel", dense)
    assert name == "b.pwconv1.weight"
    np.testing.assert_array_equal(t.numpy(), dense.T)
    assert translate("batch_stats.m.norm.bn.var", np.ones(2))[0] == "m.norm.bn.running_var"
    assert translate("params.m.gn.scale", np.ones(2))[0] == "m.gn.weight"
    with pytest.raises(KeyError):
        translate("model_0.conv.kernel", conv)


def test_semantics_pin_from_metadata(tmp_path):
    assert read_semantics(NPZ) == "windowed"
    model = DetectionModel.from_npz(NPZ, device="cpu")
    assert model.deform_semantics == "windowed"
    assert model.model_16.DyDCNV2.semantics == "windowed"
    # an exact pin in the metadata reaches the DCN
    np.savez(tmp_path / "w.npz", **_npz())
    (tmp_path / "w_metadata.json").write_text(json.dumps({"deform_semantics": "exact"}))
    assert DetectionModel.from_npz(tmp_path / "w.npz", device="cpu") \
        .model_16.DyDCNV2.semantics == "exact"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Neither JAX nor the JAX package; nor PyYAML, cv2 or matplotlib, which
    the GPU machine does not have."""
    files = sorted((ROOT / "mgdt_yolo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    banned = ("jax", "jaxlib", "flax", "optax", "mgdt_yolo_tpu", "yaml", "cv2", "matplotlib")
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, \
                f"{path.relative_to(ROOT)} imports {name}"


def test_port_imports_no_pil_and_mss_only_for_screenshots():
    """The package reads and writes images and videos without PIL, and
    imports `mss` only where JAX's screenshot loader does, lazily."""
    files = sorted((ROOT / "mgdt_yolo_tpu_torch").rglob("*.py"))
    found = {}
    for path in files:
        for name in _imports(path):
            found.setdefault(name.split(".")[0], set()).add(path.relative_to(ROOT).as_posix())
    assert "PIL" not in found, found.get("PIL")
    assert found.get("mss") == {"mgdt_yolo_tpu_torch/data/loaders.py"}
    tree = ast.parse((ROOT / "mgdt_yolo_tpu_torch" / "data" / "loaders.py").read_text())
    top = {a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names}
    assert "mss" not in top


def test_port_names_no_ffmpeg_library():
    """No file of the port (its Python, C++ and CUDA sources and
    `chip_smoke.py`) names a library of ffmpeg's to load or link, as cv2
    bundles them (`libavcodec-<hash>.so`, `libswscale*`, `-lavcodec`,
    `opencv_python.libs`): its video decoders are its own
    (`native/src/host_mpeg4.cpp`, `host_vp8.h`), and the built video library
    links none. (The MPEG-4 decoder reads an old ffmpeg's user data, which
    spells "libavcodec build: N", as ffmpeg's decoder does.)"""
    import re
    import subprocess
    from mgdt_yolo_tpu_torch.native import video
    from mgdt_yolo_tpu_torch.utils import build
    files = [p for p in sorted((ROOT / "mgdt_yolo_tpu_torch").rglob("*"))
             if p.suffix in (".py", ".cpp", ".h", ".inc", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    names = re.compile(r"lib(avcodec|avformat|avutil|avdevice|avfilter|swscale|swresample)"
                       r"[-.*_0-9]|-l(avcodec|avformat|avutil|swscale)\b|opencv_python\.libs")
    for path in files:
        found = names.search(path.read_text(errors="replace"))
        assert not found, f"{path.relative_to(ROOT)} names {found.group()}"
    video._lib()
    out = subprocess.run(["ldd", str(build.library_path(build.HOST_VIDEO))],
                         capture_output=True, text=True)
    assert out.returncode == 0 and not any(k in out.stdout for k in ("libav", "swscale",
                                                                     "opencv")), out.stdout


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        DetectionModel()
    with pytest.raises(RuntimeError):
        DetectionModel.from_npz(NPZ)
    assert resolve_device("cpu").type == "cpu"


def test_predict_on_cpu():
    """The serving entry point end to end at a small size: uint8 in,
    fixed-size detections out."""
    model = DetectionModel.from_npz(NPZ, device="cpu").fuse()
    det, counts = predict(model, synthetic_batch(2, imgsz=128))
    assert det.shape == (2, 300, 6) and counts.dtype == torch.int32
    assert torch.isfinite(det).all()
    assert (det[0, counts[0]:] == 0).all()
