"""The port's `YOLO` facade (`engine/model.py`) on the CPU, against the JAX
package's facade and against the port's own paths that are already held
against JAX.

* `predict` over a directory of PNG images (sizes whose letterbox to 96 px
  is exact, one image labelled with no object), against JAX's
  `YOLO(npz).predict(dir)`: the same paths, the same number of detections
  and classes, boxes to 1e-3 px, scores to 1e-5 (the predictor's limits,
  `tests/test_torch_predict.py`); the facade's model unchanged by it;
* `train` and `val` against the port's `Trainer` and `DetectionValidator`
  run directly (`tests/test_torch_resume.py` and `tests/test_torch_dataset.py`
  hold those against JAX): bit for bit, and `predict` then `train` bit for
  bit `train` alone;
* `load` against JAX's: the same parameters copied and the same kept;
* the refused sources, tasks and modes, and the default device.
"""
from pathlib import Path

import pytest
import torch

from mgdt_yolo_tpu.engine.model import YOLO as JaxYOLO
from mgdt_yolo_tpu_torch.engine.model import YOLO
from mgdt_yolo_tpu_torch.engine.trainer import Trainer
from mgdt_yolo_tpu_torch.engine.validator import DetectionValidator
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.weights import flax_keys, load_jax_variables
from test_torch_dataset import write_dataset, write_yaml
from test_torch_predict import CONF, EXACT_SIZES, IMGSZ, NPZ, _same_results
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TRAIN_SIZES = [(64, 64), (80, 48), (48, 80), (64, 32)]


TRAIN_ARGS = {"epochs": 1, "imgsz": 64, "batch": 2, "workers": 2, "seed": 3}


def write_counting_dir(root: Path) -> Path:
    """A YOLO dataset: train images, and val images at `EXACT_SIZES` plus
    one whose label file holds no object. Returns its data.yaml."""
    write_dataset(root, TRAIN_SIZES, "train")
    write_dataset(root, EXACT_SIZES, "val", seed=5)
    (root / "labels" / "val" / f"im{len(EXACT_SIZES) - 1}.txt").write_text("")
    return write_yaml(root)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_counting_dir(tmp_path_factory.mktemp("facade"))


@pytest.fixture(scope="module")
def jax_predictions(data):
    with pytest.MonkeyPatch.context() as mp:  # JAX's predictor saves drawn images in runs/
        mp.chdir(data.parent)
        return JaxYOLO(str(NPZ)).predict(str(data.parent / "images" / "val"), imgsz=IMGSZ,
                                         conf=CONF)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _same_state(a, b):
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ[:5]


def test_predict_over_a_directory_matches_jax(data, jax_predictions):
    y = YOLO(NPZ, device="cpu")
    before = _state(y.model)
    got = y.predict(str(data.parent / "images" / "val"), imgsz=IMGSZ, conf=CONF)
    assert [r.path for r in got] == [r.path for r in jax_predictions]
    assert _same_results(got, jax_predictions) > 0
    assert min(len(r) for r in got) >= 0 and max(len(r) for r in got) > 0
    empty = data.parent / "labels" / "val" / f"im{len(EXACT_SIZES) - 1}.txt"
    assert empty.read_text() == "" and Path(got[-1].path).stem == empty.stem
    # the facade's model is served as a folded copy: its own state is as it was
    _same_state(before, y.model.state_dict())
    assert any(isinstance(m, torch.nn.BatchNorm2d) for m in y.model.modules())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in y.predictor.model.modules())
    # `__call__` is `predict`; without keywords the predictor is kept
    again = y(str(data.parent / "images" / "val"))
    assert len(again) == len(got)


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """The facade trained after a prediction, the facade trained alone (a
    second run of the same `project`/`name`), and the port's `Trainer` run
    directly on the same arguments."""
    runs = tmp_path_factory.mktemp("runs")
    args = {**TRAIN_ARGS, "data": str(data)}
    after_predict = YOLO(NPZ, device="cpu")
    after_predict.predict(str(data.parent / "images" / "val"), imgsz=IMGSZ, conf=CONF)
    m1 = after_predict.train(**args, project=str(runs), name="a")
    alone = YOLO(NPZ, device="cpu")
    m2 = alone.train(**args, project=str(runs), name="a")
    direct = Trainer(DetectionModel.from_npz(NPZ, device="cpu"), overrides=args,
                     save_dir=runs / "c")
    m3 = direct.train()
    return (after_predict, m1), (alone, m2), (direct, m3), runs


def _no_speed(metrics):
    return {k: v for k, v in metrics.items() if k != "speed_ms_per_image"}


def test_train_matches_the_trainer_bit_for_bit(trained):
    """The facade's model after `train` holds the trainer's EMA parameters
    and current statistics; the metrics and checkpoints are the trainer's."""
    _, (alone, m2), (direct, m3), runs = trained
    want = {**direct.model.state_dict(), **direct.ema.state()}
    _same_state(want, alone.model.state_dict())
    assert _no_speed(m2) == _no_speed(m3)
    assert (alone.trainer.save_dir / "weights" / "last.npz").is_file()
    assert alone.names == direct.model.names == {0: "piglet", 1: "sow"}
    assert not alone.model.training


def test_predict_then_train_equals_train_alone(trained):
    (after_predict, m1), (alone, m2), _, _ = trained
    _same_state(alone.model.state_dict(), after_predict.model.state_dict())
    assert _no_speed(m1) == _no_speed(m2)


def test_val_matches_the_validator_bit_for_bit(trained, data):
    _, (alone, _), (direct, _), _ = trained
    args = {"data": str(data), "imgsz": 64, "batch": 2, "conf": 0.01}
    got = alone.val(**args)
    ema = DetectionModel.from_npz(NPZ, device="cpu")
    ema.load_state_dict({**direct.model.state_dict(), **direct.ema.state()})
    want = DetectionValidator(args)(ema)
    assert _no_speed(got) == _no_speed(want)


def test_run_directory_increments_as_jax(trained):
    """A second run of the same `project`/`name` goes to `<name>2`, as the
    JAX trainer's `increment_path` names it."""
    (after_predict, _), (alone, _), _, runs = trained
    assert after_predict.trainer.save_dir == runs / "a"
    assert alone.trainer.save_dir == runs / "a2" and (runs / "a2" / "results.csv").is_file()


def test_load_keeps_mismatched_parameters_as_jax():
    """`load` copies every parameter whose name and shape match, as JAX's
    non-strict `load` merges its params, and keeps the rest."""
    jy = JaxYOLO("gd_thead_yolov8.yaml")
    jy.model.set_deform_semantics("windowed")
    before_jax = load_jax_variables({"params": jy.model.variables["params"]})
    jy.load(str(NPZ))
    after_jax = load_jax_variables({"params": jy.model.variables["params"]})
    y = YOLO("gd_thead_yolov8.yaml", device="cpu")
    before = _state(y.model)
    y.load(NPZ)
    src = dict(DetectionModel.from_npz(NPZ, device="cpu").named_parameters())
    copied, kept = set(), set()
    for name, p in y.model.named_parameters():
        if name in src and src[name].shape == p.shape:
            assert torch.equal(p, src[name]), name
            copied.add(name)
        else:
            assert torch.equal(p, before[name]), name
            kept.add(name)
    jax_copied = {n for n in after_jax if not torch.equal(after_jax[n], before_jax[n])}
    assert copied and kept
    assert {n for n in copied if not torch.equal(src[n], before[n])} == jax_copied
    assert set(after_jax) == {n for n, _ in y.model.named_parameters()}
    # the BatchNorm statistics are kept, as JAX's `load` keeps its batch_stats
    stats = [k for k in flax_keys(y.model) if k.endswith("running_var")]
    assert all(torch.equal(y.model.state_dict()[k], before[k]) for k in stats)


def test_refused_sources_tasks_and_modes_raise(tmp_path):
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="export\\(format='npz'\\)"):
        YOLO(tmp_path / "ckpt", device="cpu")
    with pytest.raises(FileNotFoundError):
        YOLO(tmp_path / "best.pt", device="cpu")
    with pytest.raises(FileNotFoundError):
        YOLO(tmp_path / "missing.npz", device="cpu")
    # segment and pose are ported; classify is item 8
    for src, task in (("yolov8n-cls.yaml", None), ("yolov8n.yaml", "classify")):
        with pytest.raises(NotImplementedError, match="item 8"):
            YOLO(src, task=task, device="cpu")
    assert YOLO("yolov8n-seg.yaml", device="cpu").task == "segment"
    y = YOLO("yolov8n.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        y.track("x.png")
    # JAX's default space is no longer refused: each trial trains with it
    calls = []
    y.train = lambda **kw: calls.append(kw) or {"fitness": 0.0}
    y.tune(max_samples=2)
    assert len(calls) == 2 and all(kw[k] > 0 for kw in calls
                                   for k in ("degrees", "shear", "perspective", "mixup",
                                             "copy_paste"))
    del y.train
    with pytest.raises(NotImplementedError, match="item 8"):
        y.val(task="classify")
    # as in JAX, a `task` keyword is taken, and the facade's own task picks the validator
    assert y._overrides({"task": "pose"})["task"] == "pose"
    with pytest.raises(TypeError, match="conf"):
        y.val(conf="high")


def test_serve_answers_a_request(data):
    """`serve` starts an `InferenceServer` over the facade's model, on its
    device; a request gets the `Results` of its image."""
    from test_torch_predict import _images
    y = YOLO(NPZ, device="cpu")
    with y.serve(batch=2, imgsz=IMGSZ, conf=CONF) as server:
        got = server.submit(_images([(96, 64)], seed=1)[0]).result(timeout=120)
    assert got.orig_shape[:2] == (96, 64) and got.boxes.data.shape[1] == 6


def test_default_device_is_cuda_and_raises_without_it():
    import mgdt_yolo_tpu_torch
    assert mgdt_yolo_tpu_torch.YOLO is YOLO
    with pytest.raises(AttributeError):
        mgdt_yolo_tpu_torch.NotAThing
    if torch.cuda.is_available():
        assert YOLO(NPZ).model.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YOLO(NPZ)
    assert YOLO(NPZ, device="cpu").info()[1] == sum(
        p.numel() for p in DetectionModel.from_npz(NPZ, device="cpu").parameters())
