"""Counting over a folder (`utils/counting.py`) on the CPU against the JAX
package's `cal_model_count_error` and `cal_counting_metrics`, over one small
YOLO-format directory of PNG images whose letterbox to 96 px is exact (one
image labelled with no object), with the committed flagship weights at
conf 0.01.

Counts, TP / FP / FN exact; MAE, MSE, MAPE and R^2 within 1e-9 (the same
numpy arithmetic on the same counts; the detections behind them are held
at the predictor's limits by `tests/test_torch_facade.py`). The label
reader is exact against JAX's, and `main` runs and returns the same
numbers.
"""
from pathlib import Path

import numpy as np
import pytest

from mgdt_yolo_tpu.engine.model import YOLO as JaxYOLO
from mgdt_yolo_tpu.utils import counting as jax_counting
from mgdt_yolo_tpu_torch.engine.model import YOLO
from mgdt_yolo_tpu_torch.utils import counting
from test_torch_facade import one_torch_thread, write_counting_dir  # noqa: F401
from test_torch_predict import CONF, IMGSZ, NPZ

TOL = 1e-9


@pytest.fixture(scope="module")
def val_dir(tmp_path_factory):
    return write_counting_dir(tmp_path_factory.mktemp("counting")).parent / "images" / "val"


@pytest.fixture(scope="module")
def jax_counts(val_dir):
    """JAX's two counting functions over the directory, run once."""
    y = JaxYOLO(str(NPZ))
    kw = dict(conf=CONF, imgsz=IMGSZ)
    with pytest.MonkeyPatch.context() as mp:  # JAX's predictor saves drawn images in runs/
        mp.chdir(val_dir.parent.parent)
        return (jax_counting.cal_model_count_error(y, str(val_dir), **kw),
                jax_counting.cal_counting_metrics(y, str(val_dir), **kw))


@pytest.fixture(scope="module")
def port_counts(val_dir):
    y = YOLO(NPZ, device="cpu")
    kw = dict(conf=CONF, imgsz=IMGSZ)
    return (counting.cal_model_count_error(y, str(val_dir), **kw),
            counting.cal_counting_metrics(y, str(val_dir), **kw), y)


def _same_errors(got, want):
    assert got.keys() == want.keys() == {0, 1}
    for c in want:
        assert got[c].keys() == want[c].keys()
        for k in want[c]:
            assert abs(got[c][k] - want[c][k]) <= TOL, (c, k, got[c][k], want[c][k])


def _same_agreement(got, want):
    assert got["stats"] == want["stats"]
    assert got["r2"].keys() == want["r2"].keys()
    for c in want["r2"]:
        assert abs(got["r2"][c] - want["r2"][c]) <= TOL


def test_inputs_are_not_vacuous(port_counts, val_dir):
    """At least one image with detections and one with no ground truth."""
    *_, y = port_counts
    results = y.predict(str(val_dir), conf=CONF, imgsz=IMGSZ)
    labels = [Path(p).read_text().split("\n") for p in
              sorted((val_dir.parent.parent / "labels" / "val").glob("*.txt"))]
    assert max(len(r) for r in results) > 0
    assert any(all(not line.strip() for line in rows) for rows in labels)


def test_count_errors_match_jax(port_counts, jax_counts):
    _same_errors(port_counts[0], jax_counts[0])
    assert any(e["mae"] > 0 for e in jax_counts[0].values())


def test_counting_metrics_match_jax(port_counts, jax_counts):
    _same_agreement(port_counts[1], jax_counts[1])
    assert sum(s["fp"] + s["tp"] for s in jax_counts[1]["stats"].values()) > 0
    assert sum(s["fn"] + s["tp"] for s in jax_counts[1]["stats"].values()) > 0


@pytest.mark.parametrize("rows", [[], ["1 0.5 0.5 0.2 0.4", "0 0.1 0.2 0.05 0.1"],
                                  ["0 0.5 0.5 0.2", "1 0.25 0.75 0.5 0.5 0.9"]],
                         ids=["empty", "two", "short-and-long"])
def test_label_reader_matches_jax(tmp_path, rows):
    p = tmp_path / "x.txt"
    p.write_text("\n".join(rows))
    got, want = (m._gt_from_label_file(p, (48, 80, 3)) for m in (counting, jax_counting))
    for k in ("boxes", "cls"):
        np.testing.assert_array_equal(got[k], want[k])
    assert counting._gt_from_label_file(tmp_path / "missing.txt", (4, 4))["boxes"].shape == (0, 4)


def test_main_runs_and_returns_the_same_numbers(val_dir, port_counts, capsys):
    out = counting.main([str(NPZ), str(val_dir), "--metrics", "--device", "cpu",
                         "--imgsz", str(IMGSZ), "--conf", str(CONF)])
    _same_errors(out["errors"], port_counts[0])
    _same_agreement(out["agreement"], port_counts[1])
    printed = capsys.readouterr().out
    assert "MAE" in printed and "TP" in printed and " detections, " in printed
