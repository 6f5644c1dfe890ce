"""Export (`engine/exporter.py`) and `nn/autobackend.AutoBackend` on the
CPU, at 64 px, against the JAX package's and against the live module.

* The port's `npz` loads in JAX's `AutoBackend` and JAX's `npz` in the
  port's `YOLO`, each within 2e-5 absolute and 1e-4 relative of the other
  side's live forward (the limits of the JAX package's own reload tests,
  `tests/test_export.py`);
* the `pt2` program reloaded gives the live float32 module's bits at batch
  1 and 2 (the batch dimension is dynamic): on the CPU it runs the same
  ATen operators and the DCN's plain version;
* the exported graph holds the K1 operator (`mgdt::deform_fwd`) as one
  node, and none of the plain version's gathers;
* the `exact` pin is carried through the metadata into `AutoBackend`, and
  the model's pin is traced into the program;
* the refused formats and an unknown source raise; `benchmark` runs each
  backend and validates each to the same mAP50.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.model import YOLO as JaxYOLO
from mgdt_yolo_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from mgdt_yolo_tpu_torch.engine.exporter import Exporter
from mgdt_yolo_tpu_torch.engine.model import YOLO
from mgdt_yolo_tpu_torch.nn.autobackend import AutoBackend
from mgdt_yolo_tpu_torch.utils.benchmarks import benchmark
from test_torch_facade import one_torch_thread, write_counting_dir  # noqa: F401
from test_torch_predict import NPZ

SIZE = 64
ATOL, RTOL = 2e-5, 1e-4
JAX_META_KEYS = {"imgsz", "nc", "stride", "names", "model_yaml", "deform_semantics",
                 "layout", "output"}


def _noise(b, seed):
    return np.random.default_rng(seed).uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


def _live(y, x):
    with torch.no_grad():
        return y.model(torch.from_numpy(x))[0]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = tmp_path_factory.mktemp("export")
    y = YOLO(NPZ, device="cpu")
    arts = {fmt: Path(y.export(format=fmt, imgsz=SIZE, project=str(out))[0])
            for fmt in ("pt2", "npz")}
    return y, arts


def test_metadata_has_jax_keys(exported):
    y, arts = exported
    meta = json.loads((arts["npz"].parent / f"{arts['npz'].stem}_metadata.json").read_text())
    assert JAX_META_KEYS <= set(meta) and meta["task"] == "detect"
    assert meta["imgsz"] == SIZE and meta["nc"] == 2 and meta["stride"] == [8]
    assert meta["model_yaml"] == "mspa_c2f_gd_tood_yolov8.yaml"
    assert meta["deform_semantics"] == "windowed"
    assert arts["pt2"].stem == arts["npz"].stem


def test_port_npz_loads_in_jax_autobackend(exported):
    y, arts = exported
    x = _noise(2, 1)
    backend = JaxAutoBackend(str(arts["npz"]), imgsz=SIZE)
    assert backend.mh.deform_semantics == "windowed"
    got = backend(x)
    np.testing.assert_allclose(got, _live(y, x).numpy(), atol=ATOL, rtol=RTOL)


def test_jax_npz_loads_in_the_port_facade(tmp_path):
    jy = JaxYOLO(str(NPZ))
    art = jy.export(format="npz", imgsz=SIZE, project=str(tmp_path))[0]
    y = YOLO(art, device="cpu")
    assert y.model.deform_semantics == "windowed" and y.names == {0: "0", 1: "1"}
    x = _noise(1, 2)
    want = JaxAutoBackend(jy.model, imgsz=SIZE)(x)
    np.testing.assert_allclose(_live(y, x).numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def pt2_backend(exported):
    return AutoBackend(exported[1]["pt2"], imgsz=SIZE, device="cpu")


@pytest.mark.parametrize("batch", [1, 2])
def test_pt2_reloaded_equals_the_live_module(exported, pt2_backend, batch):
    y, arts = exported
    backend = pt2_backend
    assert backend.kind == "pt2" and backend.names == {0: "0", 1: "1"}
    assert backend.stride == (8,)
    x = _noise(batch, 3 + batch)
    got, want = backend(x), _live(y, x)
    assert got.shape == want.shape == (batch, 6, (SIZE // 8) ** 2)
    assert torch.equal(got, want)
    npz = AutoBackend(arts["npz"], imgsz=SIZE, device="cpu")
    assert npz.kind == "npz" and torch.equal(npz(x), want)
    assert backend.warmup(batch=1) is backend


def test_pt2_graph_holds_the_k1_operator(pt2_backend):
    program = pt2_backend.program
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("mgdt.deform_fwd.default") == 1
    node = next(n for n in program.graph.nodes if str(n.target) == "mgdt.deform_fwd.default")
    assert node.args[-1] == "windowed"  # the model's pin, traced into the program
    plain = re.compile(r"aten\.(gather|index|index_select|index_add|take)\b|mgdt\.deform_bwd")
    assert not [t for t in targets if plain.match(t)]
    # the batch is a symbol (its range starts at 2, export's assumption;
    # batch 1 runs, `test_pt2_reloaded_equals_the_live_module`)
    assert any(r.upper > 2 for r in program.range_constraints.values())


def test_exact_pin_reaches_the_backends(tmp_path):
    """The metadata records the `exact` pin and AutoBackend's rebuilt model
    takes it (a program traces the pin in: the test above)."""
    y = YOLO(NPZ, device="cpu")
    y.model.set_deform_semantics("exact")
    npz = Path(y.export(format="npz", imgsz=SIZE, project=str(tmp_path))[0])
    assert json.loads((tmp_path / f"{npz.stem}_metadata.json").read_text())[
        "deform_semantics"] == "exact"
    back = AutoBackend(npz, imgsz=SIZE, device="cpu")
    assert back.model.deform_semantics == "exact"
    assert back.model.model_16.DyDCNV2.semantics == "exact"
    x = _noise(1, 9)
    assert torch.equal(back(x), _live(y, x))


def test_refused_formats_and_sources_raise(exported, tmp_path):
    y, arts = exported
    with pytest.raises(RuntimeError, match="pt2"):
        y.export(format="stablehlo")
    for fmt in ("saved_model", "tflite"):
        with pytest.raises(RuntimeError, match="TensorFlow"):
            y.export(format=fmt)
    with pytest.raises(ValueError, match="onnx"):
        Exporter({"format": "onnx"})(y.model)
    (tmp_path / "m.onnx").write_bytes(b"")
    for src in (tmp_path / "m.onnx", tmp_path, tmp_path / "missing.pt2", 123):
        with pytest.raises(ValueError, match="unsupported backend source"):
            AutoBackend(src, device="cpu")
    (tmp_path / "bare.npz").write_bytes(arts["npz"].read_bytes())
    with pytest.raises(ValueError, match="metadata"):
        AutoBackend(tmp_path / "bare.npz", device="cpu")


def test_benchmark_runs_every_backend(tmp_path):
    y = YOLO(NPZ, device="cpu")
    data = write_counting_dir(tmp_path / "data")
    y.overrides["project"] = str(tmp_path / "bench")  # where its exports go
    rows = benchmark(y, imgsz=SIZE, formats=["torch", "pt2"], n_iters=2, batch=2,
                     data=str(data))
    assert [r["format"] for r in rows] == ["torch", "pt2"]
    assert all(r["ok"] and r["images_per_sec"] > 0 for r in rows)
    assert len({r["map50"] for r in rows}) == 1
    assert not benchmark(y, imgsz=SIZE, formats=["onnx"])[0]["ok"]
    with pytest.raises(ValueError, match="onnx"):
        benchmark(y, imgsz=SIZE, formats=["onnx"], hard_fail=True)
