"""The port's command line (`cfg.entrypoint`, `python -m mgdt_yolo_tpu_torch`)
and settings (`utils/settings.py`) on the CPU, against the JAX package's.

* `merge_equals_args` and `entrypoint`'s parsing: both entry points run
  with their `YOLO` replaced by a recorder of the model it is built from
  and of the mode method called with its keywords, which must be the same
  (overrides, `mode` and `task`, bare bool keys, `cfg=`, leading dashes,
  the benchmark's key filter, the grey image for a missing `source`); the
  errors of the same type and message; the special commands;
* a settings file written by one package and read by the other, both ways,
  with values that YAML would read as other types unless quoted;
* one `python -m mgdt_yolo_tpu_torch predict ... device=cpu` subprocess,
  whose per-image detection counts are the facade's, and the same command
  without `device=cpu`, which must fail where there is no CUDA device.
"""
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from mgdt_yolo_tpu import cfg as jax_cfg
from mgdt_yolo_tpu import utils as jax_utils
from mgdt_yolo_tpu.engine import model as jax_model
from mgdt_yolo_tpu_torch import cfg as port_cfg
from mgdt_yolo_tpu_torch.engine import model as port_model
from mgdt_yolo_tpu_torch.utils import settings as port_settings
from test_torch_facade import one_torch_thread, write_counting_dir  # noqa: F401
from test_torch_predict import CONF, IMGSZ, NPZ

ROOT = Path(__file__).resolve().parents[1]

MERGE_CASES = [["imgsz", "=", "640"], ["imgsz=", "640"], ["imgsz", "=640"],
               ["a", "b=1", "=", "c", "d"], ["=", "x"], ["predict", "conf=0.5"]]


@pytest.mark.parametrize("args", MERGE_CASES, ids=[" ".join(a) for a in MERGE_CASES])
def test_merge_equals_args_matches_jax(args):
    assert port_cfg.merge_equals_args(list(args)) == jax_cfg.merge_equals_args(list(args))


class Recorder:
    """Stands in for `YOLO`: records its model and the mode call."""
    calls = []

    def __init__(self, model="yolov8n.yaml", task=None, device=None):
        Recorder.calls.append(("init", model))

    def __getattr__(self, mode):
        def call(**kw):
            Recorder.calls.append((mode, kw))
            return {} if mode == "val" else []
        return call


def _run(package_cfg, package_model, args, monkeypatch):
    monkeypatch.setattr(package_model, "YOLO", Recorder)
    Recorder.calls = []
    package_cfg.entrypoint(list(args))
    return Recorder.calls


def _same_calls(got, want):
    assert len(got) == len(want)
    for (gm, gk), (wm, wk) in zip(got, want):
        assert gm == wm
        if isinstance(wk, dict):
            assert gk.keys() == wk.keys()
            for k in wk:
                if isinstance(wk[k], np.ndarray):
                    np.testing.assert_array_equal(gk[k], wk[k])
                else:
                    assert gk[k] == wk[k] and type(gk[k]) is type(wk[k]), k
        else:
            assert gk == wk


PARSE_CASES = [
    ["predict", "model=yolov8n.yaml", "source=img.jpg", "imgsz=320", "conf=0.5"],
    ["detect", "train", "data=coco.yaml", "epochs=3", "lr0", "=", "0.01", "cos_lr"],
    ["val", "imgsz=", "640", "half", "save_json=False", "device=cpu"],
    ["export", "format=npz", "--imgsz=320", "model=thead_yolov8.yaml"],
    ["predict", "save_txt=True", "max_det=None", "name=5", "source=a,"],
    ["benchmark", "imgsz=64", "batch=2", "half=True", "data=d.yaml"],
    ["predict"],
    ["mode=val", "model=gd_yolov8.yaml", "device=0"],
    ["train", "cfg={cfg}", "epochs=7"],
]


@pytest.mark.parametrize("args", PARSE_CASES, ids=[" ".join(a) for a in PARSE_CASES])
def test_entrypoint_parses_as_jax(args, monkeypatch, tmp_path):
    (tmp_path / "over.yaml").write_text("imgsz: 96\nbatch: 4\ncfg: ignored.yaml\n")
    args = [a.format(cfg=tmp_path / "over.yaml") for a in args]
    want = _run(jax_cfg, jax_model, args, monkeypatch)
    got = _run(port_cfg, port_model, args, monkeypatch)
    _same_calls(got, want)
    assert want and want[0][0] == "init"


ERROR_CASES = [["predict", "imgsz"], ["predict", "lr=0.1"], ["predict", "imgsz="],
               ["foo"], ["train", "momentun=0.9", "epoch=3"]]


@pytest.mark.parametrize("args", ERROR_CASES, ids=[" ".join(a) for a in ERROR_CASES])
def test_entrypoint_errors_match_jax(args, monkeypatch):
    with pytest.raises(Exception) as want:
        _run(jax_cfg, jax_model, args, monkeypatch)
    with pytest.raises(type(want.value)) as got:
        _run(port_cfg, port_model, args, monkeypatch)
    assert str(got.value) == str(want.value)
    assert isinstance(want.value, SyntaxError)


def test_special_commands(monkeypatch, tmp_path, caplog):
    """help, version, cfg and copy-cfg (and their aliases) build no model;
    cfg prints, and copy-cfg writes, JAX's default configuration."""
    import mgdt_yolo_tpu_torch
    caplog.set_level(logging.INFO)
    monkeypatch.chdir(tmp_path)
    for args in (["help"], ["-h"], ["--help"], ["version"], ["cfg"], ["copy-cfg"], []):
        assert _run(port_cfg, port_model, args, monkeypatch) == []
    text = caplog.text
    assert "python -m mgdt_yolo_tpu_torch" in text and mgdt_yolo_tpu_torch.__version__ in text
    copied = yaml.safe_load((tmp_path / "default_copy.yaml").read_text())
    assert copied == jax_cfg.DEFAULT_CFG_DICT and list(copied) == list(jax_cfg.DEFAULT_CFG_DICT)
    printed = [r.getMessage() for r in caplog.records if r.getMessage().startswith("task:")]
    assert yaml.safe_load(printed[0]) == jax_cfg.DEFAULT_CFG_DICT
    caplog.clear()
    port_cfg.entrypoint(["checks"])
    assert "torch" in caplog.text and "kernel build directory" in caplog.text


ODD_STRINGS = ["", "true", "123", "0x10", "~", "a: b #c", "- x", "1e5", "'q'", "naïve",
               "/x y/z", "null", "3.0"]


def test_settings_written_by_one_package_read_by_the_other(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    f = tmp_path / "settings.yaml"
    jax_default = jax_utils.get_settings(f)
    assert port_settings.get_settings(f) == jax_default   # read, not reset
    assert port_settings.get_settings(tmp_path / "p.yaml") == jax_utils.get_settings(
        tmp_path / "p.yaml")
    for s in ODD_STRINGS:
        port_settings.set_settings({"api_key": s, "sync": True, "runs_dir": f"r{s}"}, f)
        assert jax_utils.get_settings(f) == {**jax_default, "api_key": s, "sync": True,
                                             "runs_dir": f"r{s}"}
        jax_utils.set_settings({"api_key": s + "!", "sync": False}, f)
        assert port_settings.get_settings(f)["api_key"] == s + "!"
    for v in (0.001, 1e-05, 5.0, -2, None, True, float("inf")):
        assert yaml.safe_load(port_settings.yaml_dumps({"k": v}))["k"] == v
    # the `settings` command edits the file under $MGDT_CONFIG_DIR
    monkeypatch.setenv("MGDT_CONFIG_DIR", str(tmp_path / "cli"))
    port_cfg.entrypoint(["settings", "sync=True", "api_key", "=", "k: 1"])
    got = jax_utils.get_settings(tmp_path / "cli" / "settings.yaml")
    assert got["sync"] is True and got["api_key"] == "k: 1"
    with pytest.raises(KeyError):
        port_cfg.entrypoint(["settings", "nope=1"])
    port_cfg.entrypoint(["settings", "reset"])
    assert port_settings.get_settings()["sync"] is False


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run([sys.executable, "-m", "mgdt_yolo_tpu_torch", *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def test_python_m_predict_on_the_cpu(tmp_path):
    """The command line end to end in its own process: one line per image
    with the facade's detection count."""
    val = write_counting_dir(tmp_path).parent / "images" / "val"
    args = ["predict", f"model={NPZ}", f"source={val}", f"imgsz={IMGSZ}", f"conf={CONF}"]
    out = _cli(*args, "device=cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    got = {m.group(1): int(m.group(2))
           for m in re.finditer(r"^(\S+\.png): (\d+) detections", out.stdout, re.M)}
    want = port_model.YOLO(NPZ, device="cpu").predict(str(val), imgsz=IMGSZ, conf=CONF)
    assert got == {r.path: len(r) for r in want} and max(got.values()) > 0
    import torch
    if not torch.cuda.is_available():
        out = _cli(*args)
        assert out.returncode != 0 and "device='cpu'" in out.stderr


CHECK_CASES = [("2.11.0+cu128", "2.4"), ("1.9", "1.10.0"), ("3.12.3", "3.12.3"), ("abc", "0.1")]


@pytest.mark.parametrize("current,minimum", CHECK_CASES)
def test_version_and_imgsz_checks_match_jax(current, minimum):
    from mgdt_yolo_tpu.utils import checks as jax_checks
    from mgdt_yolo_tpu_torch.utils import checks
    assert checks.check_version(current, minimum) == jax_checks.check_version(current, minimum)
    for imgsz, stride in ((640, 32), (100, 32), ([95, 64], 8), (1, 16)):
        assert checks.check_imgsz(imgsz, stride) == jax_checks.check_imgsz(imgsz, stride)
    with pytest.raises(AssertionError):
        checks.check_version("1.0", "2.0", hard=True)
