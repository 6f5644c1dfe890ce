"""Reference `.pt` checkpoints in the port (`utils/torch_import.py`,
`DetectionModel.from_pt`, `YOLO("x.pt")`) against the JAX package's import
(`mgdt_yolo_tpu/utils/torch_import.py`, `YOLO("x.pt")`), on the CPU.

The checkpoints are written by `tools/reference_pt.py` in the reference's
layout (the fork's pickled module graph, fp16, `ema` and `model`,
`train_args`), from the committed flagship weights (nc 2) and from
`yolov8.yaml` (nc 80, JAX's default config) with seeded BatchNorm
statistics and biases, and from `rtdetr-l` at its published widths
(`RTDETRDetectionModel.from_pt`, `vit.RTDETR(pt)`; the fork's
`RTDETRDetectionModel` graph, q/k/v packed into `nn.MultiheadAttention`'s
`in_proj_*`). Limits, each with its reason:

* state dicts, the JAX variables and the port's state: bit for bit (the
  same fp16 values widened to float32 and relaid; both imports copy);
* the two imports' reports: equal;
* raw maps at 320 px under exact deform semantics: 1e-4, as the flagship's
  raw maps against JAX (`tests/test_torch_model.py`);
* `rtdetr-l`'s eval decoder output at 64 x 96 in float32: each query's box
  and scores within 1e-4 of the largest magnitude, as sets
  (`tests/test_torch_rtdetr.py`'s limit); `RTDETR(pt).predict` bit for bit
  `RTDETR(npz)` of the same fp16-rounded state (the same float32 weights
  through the same code).

The JAX package nests AIFI's encoder layer (`enc`) and each `DWConv`'s
convolution (`conv`): the written file keeps that nesting, the names both
importers read. Those layers named one level up, as the fork's classes
may name them, are name-missed by both alike, and the port's strict
`RTDETRDetectionModel.from_pt` refuses such a file or one that leaves a
tensor unset (`test_fork_names_of_aifi_and_dwconv_miss_in_both_imports`,
`test_rtdetr_from_pt_refuses_a_file_that_leaves_a_tensor_unset`).

Where a checkpoint's class count differs from its YAML's (a 2-class
`thead_yolov8`, whose YAML says 80) the two part on purpose: JAX builds
the YAML's 80 classes and shape-misses the class tower, the port builds
the checkpoint's 2 and loads every key (ROADMAP queue 3).
"""
import dataclasses
import os
import re
import subprocess
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.engine.model import YOLO as JaxYOLO
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.utils.torch_import import load_torch_pt as jax_load_pt
from mgdt_yolo_tpu.utils.torch_import import load_torch_state_dict as jax_load_sd
from mgdt_yolo_tpu_torch.cfg import entrypoint
from mgdt_yolo_tpu_torch.engine.model import YOLO
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel, RTDETRDetectionModel
from mgdt_yolo_tpu_torch.tools.reference_pt import write_reference_pt
from mgdt_yolo_tpu_torch.utils.torch_import import _Stub, load_torch_pt, read_torch_pt
from mgdt_yolo_tpu_torch.utils.torch_import import load_torch_state_dict
from mgdt_yolo_tpu_torch.vit import RTDETR
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, load_jax_variables,
                                         save_npz)
from test_torch_facade import one_torch_thread  # noqa: F401  (autouse)
from test_torch_rtdetr import RTOL32, H, W, _same_queries, _scenes

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "weights" / "mgdt_n_synth.npz"
ATOL_RAW = 1e-4
IMGSZ = 320


def _fp16(a):
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def seeded_state(model, seed):
    """`model` (the port's seeded init) with BatchNorm statistics, norm
    scales and every bias drawn from a numpy seed, so each tensor the
    import carries is distinct."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_var":
                a = rng.uniform(0.5, 2.0, t.shape)
            elif leaf == "running_mean" or leaf in ("bias", "reduction_bias"):
                a = rng.normal(0, 0.1, t.shape)
            elif leaf == "weight" and t.dim() == 1:
                a = 1 + rng.normal(0, 0.1, t.shape)
            else:
                continue
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


def _source(name):
    if name == "flagship":
        return DetectionModel.from_npz(NPZ, device="cpu")
    return seeded_state(DetectionModel("yolov8.yaml", device="cpu"), seed=11)


def _jax_import(path):
    """The JAX facade's `.pt` path: (JAX model pinned exact, variables,
    report, state dict)."""
    sd, train_args = jax_load_pt(str(path))
    jm = JaxDetectionModel(train_args.get("model") or "yolov8n.yaml")
    jm.set_deform_semantics("exact")
    variables, report = jax_load_sd(jm.variables, sd, verbose=False)
    return jm, variables, report, sd


def _same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module", params=["flagship", "yolov8"])
def imported(request, tmp_path_factory):
    src = _source(request.param)
    path = write_reference_pt(src, tmp_path_factory.mktemp("pt") / "best.pt")
    jm, variables, report, sd = _jax_import(path)
    model, pt = DetectionModel.from_pt(path, device="cpu")
    return request.param, src, path, jm, variables, report, sd, model, pt


def test_jax_reads_the_reference_layout(imported):
    """JAX's loader takes the written file with no miss, and its variables
    are the source's rounded through fp16."""
    name, src, _, _, variables, report, sd, _, pt = imported
    assert not report["shape_missed"] and not report["name_missed"]
    want = {k: _fp16(v) for k, v in export_variables(src).items()}
    got = {k: np.asarray(v) for k, v in flatten_variables(variables).items()}
    assert report["matched"] == len(want) == len(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the file holds the names the import skips too
    assert any(k.endswith("num_batches_tracked") for k in sd)
    assert pt.train_args["model"] == src.model_yaml and pt.nc == src.nc
    print(f"{name}: {report['matched']} keys matched, {len(sd)} in the file")


def test_port_state_is_jax_variables_carried_across(imported):
    """The port's import equals JAX's variables carried by
    `weights.translate`, bit for bit, with the same report; the model is
    pinned exact."""
    _, _, _, _, variables, report, sd, model, _ = imported
    _same_state({k: v for k, v in model.state_dict().items()
                 if not k.endswith("num_batches_tracked")},
                dict(load_jax_variables(jax.device_get(variables))))
    assert model.import_report == report
    assert model.deform_semantics == "exact"
    port_sd, train_args = load_torch_pt(imported[2])
    assert set(port_sd) == set(sd) and all(np.array_equal(port_sd[k], sd[k]) for k in sd)
    assert train_args == jax_load_pt(str(imported[2]))[1]


def test_raw_maps_under_exact_match_jax(imported):
    """Raw maps at 320 px under exact deform semantics within 1e-4 of JAX's."""
    _, _, _, jm, variables, _, _, model, _ = imported
    x = np.random.default_rng(3).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    _, want = jax.jit(lambda v, a: jm.model.apply(v, a, train=False))(variables,
                                                                       jnp.asarray(x))
    with torch.no_grad():
        _, got = model(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL_RAW)


def test_facade_and_command_line_take_a_pt(imported, tmp_path):
    """`YOLO(pt)` is `from_pt`'s model with the checkpoint kept, as JAX's
    facade names the model; `model=x.pt` on the command line reaches it."""
    name, _, path, _, _, _, _, model, _ = imported
    y = YOLO(path, device="cpu")
    assert y.ckpt is not None and set(y.ckpt) >= {"model", "ema", "train_args"}
    assert y.overrides["model"] == JaxYOLO(str(path)).overrides["model"]
    assert y.model.deform_semantics == "exact"
    _same_state(y.model.state_dict(), model.state_dict())
    if name == "flagship":
        res = entrypoint(["predict", f"model={path}", "device=cpu", "imgsz=64"])
        assert len(res) == 1 and res[0].boxes.data.shape[1] == 6


def test_bare_state_dict_and_no_ema_load(tmp_path):
    """A bare state dict loads into JAX's default config (yolov8n.yaml), and
    an `ema: None` checkpoint gives its `model`; where both are there the
    EMA wins. Both imports agree on each."""
    src = seeded_state(DetectionModel("yolov8n.yaml", device="cpu"), seed=5)
    bare = write_reference_pt(src, tmp_path / "bare.pt", bare=True)
    raw = {k: v + 1 for k, v in src.named_parameters()}
    no_ema = write_reference_pt(src, tmp_path / "no_ema.pt", model_params=raw, ema=False)
    both = write_reference_pt(src, tmp_path / "both.pt", model_params=raw)
    for path, params in ((bare, None), (no_ema, raw), (both, None)):
        jm, variables, report, sd = _jax_import(path)
        model, pt = DetectionModel.from_pt(path, device="cpu")
        assert not report["shape_missed"] and not report["name_missed"]
        assert model.import_report == report and model.model_yaml == "yolov8n.yaml"
        _same_state({k: v for k, v in model.state_dict().items()
                     if not k.endswith("num_batches_tracked")},
                    dict(load_jax_variables(jax.device_get(variables))))
        want = {k: _fp16(v) for k, v in export_variables(src, params).items()}
        got = export_variables(model)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path.name} {k}")
    assert read_torch_pt(bare).train_args == {}


def test_class_count_from_the_checkpoint(tmp_path):
    """A 2-class `thead_yolov8` (its YAML says 80): JAX builds 80 classes
    and shape-misses the class tower; the port builds the checkpoint's 2
    classes and names and loads every key."""
    src = seeded_state(DetectionModel("thead_yolov8.yaml", nc=2, device="cpu"), seed=7)
    src.names = {0: "piglet", 1: "sow"}
    path = write_reference_pt(src, tmp_path / "thead.pt")
    _, _, report, _ = _jax_import(path)
    missed = sorted(k for k, _, _ in report["shape_missed"])
    assert missed and not report["name_missed"]
    assert missed == ["model.22.cv3.bias", "model.22.cv3.weight"]
    model, _ = DetectionModel.from_pt(path, device="cpu")
    assert model.nc == 2 and model.names == src.names
    assert model.import_report["matched"] == report["matched"] + len(missed)
    assert not model.import_report["shape_missed"] and not model.import_report["name_missed"]
    want = {k: _fp16(v) for k, v in export_variables(src).items()}
    got = export_variables(model)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    print(f"JAX shape-missed {missed}")


class _Call:
    """Pickles as a call of `fn(*args)`, as a hostile checkpoint would."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("fn", [os.system, eval, subprocess.Popen],
                         ids=["os.system", "builtins.eval", "subprocess.Popen"])
def test_reading_a_checkpoint_runs_none_of_its_code(fn, tmp_path):
    """A `.pt` whose pickle calls a function outside the loader's safe set
    (a shell command, `eval`, a process) runs nothing when read: the
    function becomes a stub, and the file's tensors still load bit for
    bit."""
    marker = tmp_path / "ran"
    arg = {os.system: f"touch {marker}", eval: f"open({str(marker)!r}, 'w').close()",
           subprocess.Popen: ["touch", str(marker)]}[fn]
    w = torch.arange(6, dtype=torch.float16).reshape(2, 3) / 7
    path = tmp_path / "hostile.pt"
    torch.save({"model": OrderedDict(w=w),
                "train_args": {"model": "yolov8n.yaml", "x": _Call(fn, arg)}}, str(path))
    pt = read_torch_pt(path)
    assert not marker.exists()
    x = pt.train_args["x"]
    assert isinstance(x, _Stub) and type(x).__name__ == fn.__name__
    assert pt.train_args["model"] == "yolov8n.yaml"
    np.testing.assert_array_equal(pt.state_dict["w"], w.float().numpy())


# ---------------------------------------------------------------------------
# rtdetr-l
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rtdetr(tmp_path_factory):
    """`rtdetr-l` (nc 80) with seeded statistics, biases, norm scales and
    class embedding, written as a reference `.pt`, then read by JAX's
    import into `DetectionModel("rtdetr-l.yaml")` and by the port's
    `RTDETRDetectionModel.from_pt`."""
    src = seeded_state(RTDETRDetectionModel("rtdetr-l.yaml", device="cpu"), seed=13)
    dec = getattr(src, f"model_{src.specs[-1].i}")
    with torch.no_grad():
        dec.denoising_class_embed.copy_(torch.from_numpy(np.random.default_rng(14).normal(
            0, 1, tuple(dec.denoising_class_embed.shape)).astype(np.float32)))
    path = write_reference_pt(src, tmp_path_factory.mktemp("rtdetr") / "rtdetr-l.pt")
    jm, variables, report, sd = _jax_import(path)
    model, pt = RTDETRDetectionModel.from_pt(path, device="cpu")
    return src, path, jm, variables, report, sd, model, pt


def test_rtdetr_jax_reads_the_reference_layout(rtdetr):
    """JAX's loader takes the written `rtdetr-l` with no miss, its variables
    the source's rounded through fp16; the file holds the fork's graph:
    the model's class, the attentions packed, the decoder's lists."""
    src, _, _, variables, report, sd, _, pt = rtdetr
    assert not report["shape_missed"] and not report["name_missed"]
    want = {k: _fp16(v) for k, v in export_variables(src).items()}
    got = {k: np.asarray(v) for k, v in flatten_variables(variables).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    packed = [k for k in sd if k.endswith("in_proj_weight")]
    assert packed == ["model.11.enc.ma.in_proj_weight"] + [
        f"model.28.decoder.layers.{i}.self_attn.in_proj_weight" for i in range(6)]
    assert not any("q_proj" in k for k in sd) and "model.28.input_proj.2.1.running_var" in sd
    # 8 matched keys carry 2 attentions x (weight, bias) x 3 thirds of JAX's
    assert report["matched"] == len(want) - 7 * 2 * 2
    ema = pt.ckpt["ema"]
    assert (type(ema).__module__, type(ema).__name__) == ("ultralytics.nn.tasks",
                                                          "RTDETRDetectionModel")
    layer = ema.__dict__["_modules"]["model"]._modules["28"]
    assert type(layer).__module__ == "ultralytics.nn.modules.head"
    assert isinstance(layer.__dict__["_modules"]["decoder"].__dict__["_modules"]["layers"]
                      ._modules["0"]._modules["self_attn"], torch.nn.MultiheadAttention)
    assert pt.train_args["model"] == "rtdetr-l.yaml" and pt.nc == 80
    print(f"rtdetr-l: {report['matched']} keys matched, {len(sd)} in the file")


def test_rtdetr_port_state_is_jax_variables_carried_across(rtdetr):
    """`RTDETRDetectionModel.from_pt` equals JAX's variables carried by
    `weights.translate`, bit for bit, with the same report, the checkpoint's
    config, class count and names."""
    src, _, _, variables, report, _, model, pt = rtdetr
    _same_state({k: v for k, v in model.state_dict().items()
                 if not k.endswith("num_batches_tracked")},
                dict(load_jax_variables(jax.device_get(variables))))
    assert model.import_report == report
    assert model.model_yaml == "rtdetr-l.yaml" and model.nc == 80 and model.names == src.names
    assert not model.training


def test_rtdetr_decoder_output_matches_jax(rtdetr):
    """The eval forward of both imports at 64 x 96 (126 tokens, all taken):
    boxes and scores as sets within `tests/test_torch_rtdetr.py`'s float32
    limit, and the encoder's outputs."""
    _, _, jm, variables, _, _, model, _ = rtdetr
    x = np.random.default_rng(5).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    want = jax.device_get(jax.jit(lambda v, a: jm.model.apply(v, a, train=False)[0][:4])(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got[0].shape == (1, 2, 126, 4) and got[1].shape == (1, 2, 126, 80)
    _same_queries(got[0][0].numpy(), got[1][0].numpy(), want[0][0], want[1][0], RTOL32,
                  "rtdetr-l from the .pt")
    _same_queries(got[2].numpy(), got[3].numpy(), want[2], want[3], RTOL32, "encoder")


def test_rtdetr_facade_takes_the_pt_as_the_npz_of_its_state(rtdetr, tmp_path):
    """`vit.RTDETR(pt)` predicts what `vit.RTDETR(npz)` of the source's
    fp16-rounded state predicts, bit for bit; the checkpoint is kept;
    `YOLO` still refuses the file (it would serve it through NMS)."""
    src, path, _, _, _, _, _, _ = rtdetr
    rounded = {k: v.half().float() for k, v in src.state_dict().items() if v.is_floating_point()}
    npz = save_npz(src, tmp_path / "rounded.npz", {"model_yaml": "rtdetr-l.yaml", "nc": 80},
                   params=rounded)
    from_pt, from_npz = RTDETR(str(path), device="cpu"), RTDETR(str(npz), device="cpu")
    assert from_pt.ckpt is not None and set(from_pt.ckpt) >= {"model", "ema", "train_args"}
    _same_state(from_pt.model.state_dict(), from_npz.model.state_dict())
    got = from_pt.predict(_scenes(), imgsz=64, conf=0.0, batch=2)
    want = from_npz.predict(_scenes(), imgsz=64, conf=0.0, batch=2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g.boxes) == 84
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
    with pytest.raises(ValueError, match="RT-DETR"):
        YOLO(path, device="cpu")


def test_fork_names_of_aifi_and_dwconv_miss_in_both_imports(rtdetr):
    """Were AIFI a `TransformerEncoderLayer` keeping its modules at the top
    (`model.11.ma.*`) and each `DWConv` a `Conv` keeping its conv and norm
    (`model.2.conv.weight`, `model.2.bn.*`), as the fork's classes are
    thought to be (no fork file is in the repository to show it), where JAX
    nests them one level down: renamed so, those keys are name-missed by
    JAX's import and the port's alike, with equal reports, and the port's
    `RTDETRDetectionModel.from_pt` refuses the file, naming them, where a
    part load would serve seeded layers."""
    src, _, jm, _, _, sd, _, pt = rtdetr
    renamed = {}
    for k, v in sd.items():
        k = k.replace("model.11.enc.", "model.11.")
        k = re.sub(r"^(model\.(?:2|4|8)\.|.*\.conv2\.)conv\.(conv|bn)\.", r"\1\2.", k)
        renamed[k] = v
    _, want = jax_load_sd(jm.variables, renamed, verbose=False)
    port = RTDETRDetectionModel("rtdetr-l.yaml", device="cpu")
    got = load_torch_state_dict(port, renamed, verbose=False)
    assert got == want and not want["shape_missed"]
    missed = [k for k in renamed if k not in sd and not k.endswith("num_batches_tracked")]
    assert sorted(want["name_missed"]) == sorted(missed)
    # AIFI's 12 tensors; 3 DWConvs and 24 LightConvs' conv2, 5 tensors each
    assert len(missed) == 12 + 27 * 5
    with pytest.raises(KeyError, match=r"147 keys name-missed \['model\.2\.conv\.weight'"):
        RTDETRDetectionModel.from_pt(dataclasses.replace(pt, state_dict=renamed), device="cpu")
    print(f"the fork's names: {len(missed)} of {len(sd)} keys name-missed by both imports")


@pytest.mark.parametrize("drop", ["model.11.enc.norm1.weight",
                                  "model.28.dec_bbox_head.5.layers.2.bias"])
def test_rtdetr_from_pt_refuses_a_file_that_leaves_a_tensor_unset(rtdetr, drop):
    """A file without one of the model's tensors (AIFI's first norm, the
    last box head's last bias) is refused by name, where JAX's import and
    `DetectionModel.from_pt` would leave the tensor at its init."""
    *_, sd, _, pt = rtdetr
    assert drop in sd
    part = dataclasses.replace(pt, state_dict={k: v for k, v in sd.items() if k != drop})
    with pytest.raises(KeyError, match=r"0 keys name-missed .* 1 of the model's tensors unset"):
        RTDETRDetectionModel.from_pt(part, device="cpu")
