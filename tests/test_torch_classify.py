"""The classify task of the port against the JAX package on the CPU: the
`Classify` head, `ClassificationModel`, the dataset (synthetic and folder),
the trainer's step and a 2-epoch run, the validator, the predictor, `Probs`
and `Results` with `probs`, the facade, the CLI, npz export with
`AutoBackend`, and reference `.pt` import.

Models are `yolov8n-cls.yaml` at nc 8 (top-5 then ranks 8 classes) from
JAX's seeded variables carried across by `weights.load_jax_variables`,
with randomised norm statistics, scales and biases where a forward alone is
compared; images are JAX's synthetic split at 32 px. Tolerances, each with
its reason:

* the head and the model's forward: the eval probabilities (float32) and
  the training logits to 1e-5 of their magnitude (at least 1), the model's
  training logits in float64 (flax's and torch's BatchNorm take the batch
  variance in different orders, which float32 carries ~3e-5 apart through
  the randomised model);
* two SGD steps in float32 on both sides, as JAX's classify trainer runs
  them: each step's loss 1e-5 relative, each gradient of the first step
  1e-3 of that tensor's largest, the EMA's change after both 1e-3 of that
  tensor's largest change plus one float32 spacing of its values;
* the 2-epoch run: per epoch top-1 and top-5, and the best epoch, equal;
* the folder dataset: the resize is cv2's INTER_LINEAR in numpy, held as
  the letterbox is (`tests/test_torch_letterbox.py`): bit for bit on ratio
  1 and integer down-ratios, elsewhere one grey level in at most 0.5% of
  the values;
* the predictor's probabilities 1e-5.
"""
import json
import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgdt_yolo_tpu.cfg import get_cfg as jax_get_cfg
from mgdt_yolo_tpu.engine import classify as JCL
from mgdt_yolo_tpu.engine import results as jax_results
from mgdt_yolo_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from mgdt_yolo_tpu.nn.modules.head import Classify as JaxClassify
from mgdt_yolo_tpu.nn.tasks import ClassificationModel as JaxClassificationModel
from mgdt_yolo_tpu.utils.torch_import import load_torch_pt as jax_load_torch_pt
from mgdt_yolo_tpu.utils.torch_import import load_torch_state_dict as jax_load_state_dict
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.cfg import entrypoint
from mgdt_yolo_tpu_torch.engine import classify as CL
from mgdt_yolo_tpu_torch.engine import results as port_results
from mgdt_yolo_tpu_torch.engine.model import TASK_MAP, YOLO
from mgdt_yolo_tpu_torch.engine.results import Results
from mgdt_yolo_tpu_torch.nn.autobackend import AutoBackend
from mgdt_yolo_tpu_torch.nn.modules.head import Classify
from mgdt_yolo_tpu_torch.nn.tasks import ClassificationModel, DetectionModel
from mgdt_yolo_tpu_torch.tools.reference_pt import write_reference_pt
from mgdt_yolo_tpu_torch.weights import (export_variables, flatten_variables, flax_keys,
                                         load_jax_variables, load_state)
from test_torch_ablation_train import _close, _flax
from test_torch_model import _randomize
from test_torch_train import _nest
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NC, IMGSZ, BATCH = 8, 32, 16
RUN = {"data": "synthetic", "imgsz": IMGSZ, "batch": BATCH, "epochs": 2, "lr0": 0.01}


@pytest.fixture(scope="module")
def start():
    """JAX's classifier at nc 8, and its variables with randomised norm
    statistics, scales and biases (flat)."""
    jm = JaxClassificationModel("yolov8n-cls.yaml", nc=NC)
    return jm, _randomize(jm.variables, seed=3)


def _port(flat):
    pm = ClassificationModel("yolov8n-cls.yaml", nc=NC, device="cpu")
    load_state(pm, load_jax_variables(flat))
    return pm


def _images(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


# ---------------------------------------------------------------------------
# the head and the model
# ---------------------------------------------------------------------------

def test_classify_head_matches_jax():
    """conv(1280) -> mean -> linear: logits in training (no dropout), a
    float32 softmax in eval, from a list input concatenated."""
    x = np.random.default_rng(0).standard_normal((3, 5, 6, 16)).astype(np.float32)
    jh = JaxClassify(NC)
    flat = _randomize(jh.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    ph = Classify(16, NC)
    load_state(ph, load_jax_variables(flat))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for train in (True, False):  # (the port's training forward moves its statistics)
        load_state(ph, load_jax_variables(flat))
        want = jax.jit(lambda v, x: jh.apply(v, x, train=train, mutable=["batch_stats"]
                                             if train else False))(_nest(flat), jnp.asarray(x))
        want = np.asarray(want[0] if train else want)
        ph.train(train)
        with torch.no_grad():
            got = ph(xt).numpy()
        assert got.shape == want.shape == (3, NC)
        _close(got, want, 0.0, f"train={train}", atol=1e-5 * max(1.0, np.abs(want).max()))
    assert got.dtype == np.float32 and np.allclose(got.sum(-1), 1.0, atol=1e-6)
    with torch.no_grad():
        both = ph([xt[:, :10], xt[:, 10:]])
    torch.testing.assert_close(both, torch.from_numpy(got), rtol=0, atol=0)


def test_model_structure_and_forward_match_jax(start):
    """`yolov8n-cls.yaml` by name: specs, flax names, parameter count,
    stride (1,), names and the nc override as JAX's; the training logits and
    eval probabilities after the carry; the scale letter picks the width."""
    jm, flat = start
    pm = _port(flat)
    assert (pm.task, pm.stride, pm.nc, pm.model_yaml) == ("classify", (1,), NC,
                                                          "yolov8n-cls.yaml")
    assert pm.names == jm.names == {i: str(i) for i in range(NC)}
    assert [(s.i, s.f, s.name, s.n, s.c2) for s in pm.specs] == \
        [(s.i, s.f, s.name, s.n, s.c2) for s in jm.specs]
    assert set(flax_keys(pm).values()) == set(flat)
    assert sum(p.numel() for p in pm.parameters()) == jm.num_params()
    assert ClassificationModel(device="cpu").nc == 1000
    assert ClassificationModel("yolov8s-cls.yaml", nc=NC, device="cpu").model_0.conv \
        .out_channels == 32
    with pytest.raises(ValueError, match="not Classify"):
        ClassificationModel("yolov8n.yaml", device="cpu")
    with pytest.raises(ValueError, match="ClassificationModel"):
        DetectionModel("yolov8n-cls.yaml", device="cpu")
    # 4 images at 64 px: the stride-32 stage's training BatchNorm then takes 16 values a
    # channel (at 32 px and b2 it would normalise 2, where float32 rounding decides)
    x = np.random.default_rng(1).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.model.apply(v, x, train=False))(
        _nest(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    _close(got, want, 0.0, "eval probabilities", atol=1e-5)
    # the training logits in float64 on both sides: flax's and torch's BatchNorm take
    # the batch variance in different orders, which float32 carries ~3e-5 apart here
    with jax.enable_x64(True):
        j64 = JaxClassificationModel("yolov8n-cls.yaml", nc=NC, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(flat))
        want = np.asarray(jax.jit(lambda v, x: j64.model.apply(
            v, x, train=True, mutable=["batch_stats"])[0])(v64, jnp.asarray(x, jnp.float64)))
    with torch.no_grad():
        got = pm.double().train()(torch.from_numpy(x).double()).numpy()
    _close(got, want, 0.0, "training logits", atol=1e-5 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_split_bit_for_bit():
    """The class hues from `seed`, the noise from the same generator or from
    `noise_seed`, and every batch (shuffled by its seed, RGB, /255, the tail
    dropped), as JAX's arrays."""
    for kw in ({"seed": 0}, {"seed": 5, "noise_seed": 5 + 9991}):
        ours = CL.ClassificationDataset(None, imgsz=IMGSZ, nc=NC, n_synth=40, **kw)
        theirs = JCL.ClassificationDataset(None, imgsz=IMGSZ, nc=NC, n_synth=40, **kw)
        assert ours.names == theirs.names and len(ours) == len(theirs) == 40
        for (a, ca), (b, cb) in zip(ours.items, theirs.items):
            assert ca == cb
            np.testing.assert_array_equal(a, b)
        for shuffle, seed in ((True, 3), (False, 0)):
            got = list(ours.batches(BATCH, shuffle=shuffle, seed=seed))
            want = list(theirs.batches(BATCH, shuffle=shuffle, seed=seed))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g["img"].dtype == w["img"].dtype == np.float32
                np.testing.assert_array_equal(g["img"], w["img"])
                np.testing.assert_array_equal(g["label"], w["label"])


def _folder(root, sizes, ext="png"):
    """root/<class>/<i>.<ext>, three classes, seeded scenes."""
    for i, img in enumerate(_images(sizes, seed=7)):
        d = root / f"class{i % 3}"
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"{i}.{ext}"), img)
    return root


def test_folder_dataset_matches_cv2(tmp_path):
    """`root/<class>/*` in sorted order, read by the port's decoder and
    resized by `resize_linear`, against JAX's `cv2.imread` + `cv2.resize`,
    exact on ratio 1 and 2x down; a JPEG needs the card's decoder."""
    sizes = [(32, 32), (64, 64), (50, 70), (33, 47), (128, 96), (20, 90)]
    root = _folder(tmp_path / "png", sizes)
    ours = CL.ClassificationDataset(str(root), imgsz=IMGSZ)
    theirs = JCL.ClassificationDataset(str(root), imgsz=IMGSZ)
    assert ours.names == theirs.names == {0: "class0", 1: "class1", 2: "class2"}
    assert [(str(f), c) for f, c in ours.items] == [(str(f), c) for f, c in theirs.items]
    got = ours.load(list(range(len(ours))))
    for (f, _), g in zip(theirs.items, got):
        w = cv2.resize(cv2.imread(f), (IMGSZ, IMGSZ))
        d = np.abs(g.astype(np.int32) - w)
        if cv2.imread(f).shape[0] in (32, 64):
            np.testing.assert_array_equal(g, w)
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, f
    b = next(ours.batches(4, shuffle=False))
    assert b["img"].shape == (4, IMGSZ, IMGSZ, 3) and b["label"].tolist() == [0, 0, 1, 1]
    jpg = _folder(tmp_path / "jpg", sizes[:2], ext="jpg")
    if not native.has_jpeg():
        with pytest.raises(native.DecodeError, match="CUDA"):
            CL.ClassificationDataset(str(jpg), imgsz=IMGSZ).load([0])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

STEP = {**RUN, "optimizer": "SGD", "warmup_epochs": 0.0, "weight_decay": 0.05,
        "momentum": 0.9}


def _jax_step(jm, a):
    """JAX's classify step (`engine/classify.py`), with its optimizer's
    arguments, jitted."""
    spe = 64 // a.batch
    tx = jax_build_optimizer(
        jm.variables["params"], a.optimizer, lr0=a.lr0, lrf=a.lrf, momentum=a.momentum,
        weight_decay=a.weight_decay, warmup_steps=int(a.warmup_epochs * spe),
        total_steps=spe * a.epochs, steps_per_epoch=spe, epochs=a.epochs, cos_lr=False,
        warmup_momentum=a.warmup_momentum, nc=NC, warmup_bias_lr=a.warmup_bias_lr)

    def loss_fn(p, batch_stats, img, label):
        logits, upd = jm.model.apply({"params": p, "batch_stats": batch_stats}, img,
                                     train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), label).mean()
        return ce, upd["batch_stats"]

    @jax.jit
    def step(params, batch_stats, opt_state, ema, n_upd, img, label):
        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch_stats, img, label)
        updates, new_opt = tx.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        n = n_upd + 1
        d = 0.9999 * (1 - jnp.exp(-n.astype(jnp.float32) / 2000.0))
        new_ema = jax.tree.map(lambda e, p: e * d + (1.0 - d) * p, ema, new_params)
        return new_params, new_bs, new_opt, new_ema, n, loss, grads
    return tx, step


def test_two_sgd_steps_match_jax(start):
    """JAX's classify trainer's optimizer arguments (no nominal-batch
    scaling), the float32 cross-entropy, the first step's gradients, each
    step's loss and the ramped EMA after two steps (the first at the
    warm-up's zero rate, the second at lr0)."""
    jm, flat = start
    a = jax_get_cfg(overrides=STEP)
    tx, step = _jax_step(jm, a)
    params = _nest({k: v for k, v in flat.items() if k.startswith("params.")})["params"]
    stats = _nest({k: v for k, v in flat.items() if k.startswith("batch_stats.")})
    stats = stats["batch_stats"]
    state = [params, stats, tx.init(params), params, jnp.zeros((), jnp.int32)]
    pm = _port(flat)
    tr = CL.ClassificationTrainer(pm, overrides=STEP)
    assert tr.optimizer.kind == "sgd" and tr.optimizer.weight_decay == 0.05
    batches = list(CL.ClassificationDataset(None, imgsz=IMGSZ, nc=NC).batches(BATCH))[:2]
    keys = flax_keys(pm)
    for i, b in enumerate(batches):
        *state, loss, grads = step(*state, jnp.asarray(b["img"]), jnp.asarray(b["label"]))
        if i == 0:  # the port's gradients, before its optimizer steps
            pm.train()
            img, label = CL._to_device(b, pm.device)
            torch.nn.functional.cross_entropy(pm(img).float(), label).backward()
            want = flatten_variables(jax.device_get(grads), "params.")
            for n, p in pm.named_parameters():
                _close(_flax(keys[n], p.grad), want[keys[n]], 1e-3, f"gradient of {n}")
                p.grad = None
            load_state(pm, load_jax_variables(flat))  # the forward moved the statistics
        got = tr.train_step(*CL._to_device(b, pm.device))
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    ema = flatten_variables(jax.device_get(state[3]), "params.")
    ours = tr.ema.state()
    assert tr.ema.updates == 2
    for n, p in pm.named_parameters():
        k, base = keys[n], flat[keys[n]].astype(np.float64)
        want = ema[k] - base
        _close(_flax(k, ours[n]) - base, want, 1e-3, f"EMA change of {n}",
               atol=float(np.finfo(np.float32).eps) * np.abs(base).max())


def test_two_epoch_run_matches_jax(start, monkeypatch):
    """JAX's recipe end to end on the synthetic split: per epoch the EMA
    weights' top-1 and top-5 on the held-out noise split (seed + 9991),
    the best epoch (ties to the later), and the results returned."""
    jm, _ = start
    seen = []
    original = JCL.ClassificationValidator.__call__

    def record(self, mh, dataset=None):
        seen.append(original(self, mh, dataset))
        return seen[-1]
    monkeypatch.setattr(JCL.ClassificationValidator, "__call__", record)
    pm = ClassificationModel("yolov8n-cls.yaml", nc=NC, device="cpu")
    load_state(pm, load_jax_variables(flatten_variables(jax.device_get(jm.variables))))
    want = JCL.ClassificationTrainer(overrides={**RUN, "mode": "train"}, model=jm).train()
    tr = CL.ClassificationTrainer(pm, overrides=RUN)
    assert len(tr.train_ds) == 64 and tr.val_ds.items[0][1] == 0
    got = tr.train()
    assert [(r["top1"], r["top5"]) for r in tr.epoch_results] == \
        [(r["top1"], r["top5"]) for r in seen]
    assert got == want
    best = max(range(2), key=lambda e: (seen[e]["top1"], e))
    assert tr.best_epoch == best and len(tr.losses) == 8
    print(f"\nclassify 2 epochs: {tr.epoch_results}, best epoch {best}")


def test_checkpoints_final_weights_and_float32(tmp_path):
    """With a `save_dir`, `weights/best.npz` and `weights/last.npz` in the
    port's npz format (JAX writes orbax directories: a kept difference);
    the model ends holding the best epoch's EMA weights, which `best.npz`
    reloads bit for bit; the step runs in float32 with TF32 off (JAX's has
    no `amp`), the flags put back after."""
    pm = ClassificationModel("yolov8n-cls.yaml", nc=NC, device="cpu")
    tr = CL.ClassificationTrainer(pm, overrides={**RUN, "epochs": 1}, save_dir=tmp_path)
    res = tr.train()
    assert set(res) == {"top1", "top5", "best_top1"}
    w = tmp_path / "weights"
    assert (w / "best.npz").is_file() and (w / "last.npz").is_file()
    meta = json.loads((w / "best_metadata.json").read_text())
    assert (meta["task"], meta["model_yaml"], meta["nc"]) == ("classify", "yolov8n-cls.yaml", NC)
    back = ClassificationModel.from_npz(w / "best.npz", device="cpu")
    for (n, a), (_, b) in zip(pm.state_dict().items(), back.state_dict().items()):
        if not n.endswith("num_batches_tracked"):
            assert torch.equal(a, b), n
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with CL.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        pm.train()
        assert pm(torch.zeros(2, IMGSZ, IMGSZ, 3)).dtype == torch.float32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == old


def test_validator_drops_the_tail_as_jax(start):
    """Top-1 and top-5 over full batches only: 20 images at b16 count 16
    (JAX's rule; the reference counts all 20, a kept difference)."""
    jm, flat = start
    jm.variables = _nest(flat)
    pm = _port(flat)
    ds = CL.ClassificationDataset(None, imgsz=IMGSZ, nc=NC, n_synth=20)
    jds = JCL.ClassificationDataset(None, imgsz=IMGSZ, nc=NC, n_synth=20)
    args = {"imgsz": IMGSZ, "batch": BATCH}
    got = CL.ClassificationValidator(args)(pm, dataset=ds)
    want = JCL.ClassificationValidator(jax_get_cfg(overrides={**args, "mode": "val"}))(
        jm, dataset=jds)
    assert got == want and (got["top1"] * 16) % 1 == 0


# ---------------------------------------------------------------------------
# prediction and results
# ---------------------------------------------------------------------------

def test_predictor_matches_jax(start, tmp_path):
    """Each image resized to the square imgsz, RGB /255, the eval forward:
    one `Results` with `probs` an image, from arrays and from a directory,
    as JAX's."""
    jm, flat = start
    jm.variables = _nest(flat)
    pm = _port(flat)
    imgs = _images([(48, 64), (32, 32), (70, 33)], seed=4)
    root = _folder(tmp_path, [(40, 56), (64, 64)])
    jp = JCL.ClassificationPredictor(jax_get_cfg(overrides={"imgsz": IMGSZ, "mode": "predict"}))
    jp.setup_model(jm)
    ours = CL.ClassificationPredictor({"imgsz": IMGSZ, "device": "cpu"}).setup_model(pm)
    for source, batch in ((imgs, 1), (imgs, 3), (str(root), 2)):
        want, got = jp(source), ours(source, batch=batch)
        assert len(got) == len(want) == (3 if isinstance(source, list) else 2)
        for g, w in zip(got, want):
            assert g.path == w.path and len(g) == 0 and g.keys == w.keys == ["probs"]
            np.testing.assert_allclose(g.probs.data, np.asarray(w.probs.data), rtol=0,
                                       atol=1e-5)
            assert g.probs.top1 == w.probs.top1 and g.probs.top5 == w.probs.top5
    assert list(ours(imgs[:1], stream=True))[0].probs.data.dtype == np.float32


def test_probs_and_results_match_jax(monkeypatch):
    """`Probs` fields, `verbose()`'s top five, `update(probs=)`, and
    `save_crop`/`tojson`'s warnings and results as JAX's; `plot` draws only
    boxes in JAX, so a probabilities-only result plots as the image."""
    p = np.array([0.06, 0.3, 0.1, 0.2, 0.02, 0.25, 0.03, 0.04], np.float32)
    img = _images([(20, 30)], seed=1)[0]
    names = {i: f"c{i}" for i in range(8)}
    ours, theirs = Results(img, "a.jpg", names, probs=p), \
        jax_results.Results(img, "a.jpg", names, probs=p)
    for f in ("top1", "top5", "top1conf", "top5conf"):
        assert getattr(ours.probs, f) == getattr(theirs.probs, f), f
    assert len(ours.probs) == 8 and ours.probs.shape == (8,)
    assert ours.verbose() == theirs.verbose() == "c1 0.30, c5 0.25, c3 0.20, c2 0.10, c0 0.06, "
    assert ours.keys == theirs.keys == ["probs"]
    warned = {"ours": [], "theirs": []}
    monkeypatch.setattr(port_results.LOGGER, "warning", warned["ours"].append)
    monkeypatch.setattr(jax_results.LOGGER, "warning", warned["theirs"].append)
    assert ours.tojson() is None and theirs.tojson() is None
    assert ours.save_crop("x") is None and theirs.save_crop("x") is None
    assert warned["ours"] == warned["theirs"] == ["Classify task does not support tojson yet",
                                                  "Classify task does not support save_crop"]
    np.testing.assert_array_equal(ours.plot(), theirs.plot())
    np.testing.assert_array_equal(ours.plot(), img)
    q = ours.update(probs=p[::-1].copy())
    assert q is ours and ours.probs.top1 == 6


# ---------------------------------------------------------------------------
# the facade, the CLI, export and import
# ---------------------------------------------------------------------------

def test_facade_trains_validates_predicts_and_exports(tmp_path):
    """`YOLO("yolov8n-cls.yaml")` through TASK_MAP: `train` is the direct
    trainer's run bit for bit (the model ends with its best weights), `val`
    the validator's, `predict` the predictor's; npz export and
    `AutoBackend(npz)` give the live forward bit for bit, and `YOLO(npz)`
    is a classify model again."""
    assert TASK_MAP["classify"][0] is ClassificationModel
    y = YOLO("yolov8n-cls.yaml", device="cpu")
    ref = ClassificationModel("yolov8n-cls.yaml", device="cpu")
    args = {"data": "synthetic", "imgsz": IMGSZ, "batch": BATCH, "epochs": 1}
    got = y.train(**args, project=str(tmp_path), name="run")
    want = CL.ClassificationTrainer(ref, overrides=args).train()
    assert got == want and (tmp_path / "run" / "weights" / "best.npz").is_file()
    for (n, a), (_, b) in zip(y.model.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), n
    assert y.val(data="synthetic", imgsz=IMGSZ, batch=BATCH) == \
        CL.ClassificationValidator({"imgsz": IMGSZ, "batch": BATCH})(ref)
    imgs = _images([(40, 50)], seed=2)
    r = y.predict(imgs, imgsz=IMGSZ)[0]
    w = CL.ClassificationPredictor({"imgsz": IMGSZ}).setup_model(ref)(imgs)[0]
    np.testing.assert_array_equal(r.probs.data, w.probs.data)
    path = y.export(format="npz", imgsz=IMGSZ, project=str(tmp_path))[0]
    meta = json.loads(open(path.replace(".npz", "_metadata.json")).read())
    assert (meta["task"], meta["stride"], meta["model_yaml"]) == ("classify", [1],
                                                                  "yolov8n-cls.yaml")
    x = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with torch.no_grad():
        live = y.model(torch.from_numpy(x))
    back = AutoBackend(path, imgsz=IMGSZ, device="cpu")
    assert back.stride == (1,)
    torch.testing.assert_close(back.forward(x), live, rtol=0, atol=0)
    again = YOLO(path, device="cpu")
    assert again.task == "classify" and isinstance(again.model, ClassificationModel)


def test_cli_routes_the_classify_task(tmp_path, monkeypatch, caplog):
    """`classify train|val|predict` parse as JAX's; one in-process run of
    each on the CPU, the predictions logged as their top five."""
    from mgdt_yolo_tpu import cfg as jax_cfg
    from mgdt_yolo_tpu.engine import model as jax_model
    from mgdt_yolo_tpu_torch.engine import model as port_model
    from test_torch_cli import _run, _same_calls
    for args in (["classify", "train", "model=yolov8n-cls.yaml", "imgsz=32", "epochs=1"],
                 ["classify", "val", "model=yolov8n-cls.yaml", "batch=16"],
                 ["classify", "predict", "model=yolov8n-cls.yaml", "source=x.png"]):
        want = _run(jax_cfg, jax_model, args, monkeypatch)
        got = _run(__import__("mgdt_yolo_tpu_torch.cfg", fromlist=["x"]), port_model, args,
                   monkeypatch)
        _same_calls(got, want)
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    _folder(tmp_path / "imgs", [(40, 56)])
    common = ["model=yolov8n-cls.yaml", "device=cpu", "imgsz=32", "batch=16"]
    res = entrypoint(["classify", "train", *common, "epochs=1", f"project={tmp_path}"])
    assert set(res) == {"top1", "top5", "best_top1"}
    assert set(entrypoint(["classify", "val", *common])) == {"top1", "top5"}
    with caplog.at_level(logging.INFO):
        out = entrypoint(["classify", "predict", *common, f"source={tmp_path / 'imgs'}"])
    assert len(out) == 1 and out[0].probs is not None
    assert any(out[0].verbose() in m for m in caplog.messages)


def test_reference_pt_reads_as_jax(start, tmp_path):
    """A reference `.pt` of a classifier (the `Classify` head's conv and
    `linear`) reads through JAX's import and the port's to the same values,
    bit for bit; `YOLO(".pt")` takes the classify task from its model."""
    jm, flat = start
    pm = _port(flat)
    pt = write_reference_pt(pm, tmp_path / "best.pt")
    sd, train_args = jax_load_torch_pt(pt)
    assert "model.9.linear.weight" in sd and train_args["model"] == "yolov8n-cls.yaml"
    want, rep = jax_load_state_dict(JaxClassificationModel("yolov8n-cls.yaml",
                                                           nc=NC).variables, sd, verbose=False)
    assert rep["name_missed"] == rep["shape_missed"] == []
    ours, _ = ClassificationModel.from_pt(pt, device="cpu")
    assert ours.import_report["matched"] == rep["matched"]
    got = export_variables(ours)
    for k, v in flatten_variables(jax.device_get(want)).items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)
    y = YOLO(pt, device="cpu")
    assert y.task == "classify" and isinstance(y.model, ClassificationModel)
