"""The classify task: its dataset, trainer, validator and predictor, the
counterparts of the JAX package's `mgdt_yolo_tpu/engine/classify.py`.

`ClassificationDataset` is a `root/<class>/*` folder, read by the port's
decoder (`native`) and resized to `imgsz` x `imgsz` with cv2's INTER_LINEAR
(`data.augment.resize_linear`, no letterbox), or JAX's synthetic split:
per class a hue drawn from `seed`, per image Gaussian noise from the same
generator, or from `noise_seed` for a held-out split, the same arrays bit
for bit. `batches` drops the tail and gives RGB float32 in [0, 1], as JAX's.

`ClassificationTrainer` is JAX's loop: the JAX trainer's optimizer chain
(`engine.trainer.Optimizer`, with the arguments JAX's classify trainer
gives `build_optimizer`: no nominal-batch scaling of the decay, no
accumulation), cross-entropy in float32 on the logits, an EMA of the
parameters with the ramped decay 0.9999 (1 - exp(-n / 2000)), and after
every epoch a validation of the EMA parameters with the current BatchNorm
statistics, the best top-1 (ties to the later epoch) kept. The step runs in
float32 with TF32 off, as JAX's runs without `amp`. With a `save_dir` it
writes `weights/best.npz` whenever an epoch is the best so far and
`weights/last.npz` after the last epoch, in the port's npz format (JAX
writes orbax directories); the model ends holding the best epoch's
weights. The data follow JAX's rules: `data/train` and `data/val` where
`data` has a `train` folder, else the one folder for both, else the
synthetic split with the validation noise from `seed + 9991`.

`ClassificationValidator` gives top-1 and top-5 over full batches (the tail
is dropped, as in JAX); `ClassificationPredictor` resizes each image to
`imgsz` square, flips BGR to RGB, scales by 1/255, and returns one
`Results` with `probs` per image. Keys JAX's classify engines do not read
(augmentation, loss gains, `amp`, ...) are accepted and unused, as there.
"""
from __future__ import annotations

import contextlib
import copy
import logging
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..cfg import get_cfg
from ..data.augment import resize_linear
from ..data.loaders import load_inference_source
from ..device import names_device, parse_device
from ..nn.tasks import ClassificationModel
from ..utils.callbacks import CallbackMixin
from ..weights import flax_keys, save_npz
from .results import Results
from .trainer import EMA, Optimizer

LOGGER = logging.getLogger(__name__)
SYNTH = (None, "synthetic")


class ClassificationDataset:
    """`root/<class name>/*` images, classes in sorted order, or, where
    `root` is no directory, `n_synth` synthetic images of `nc` classes."""

    def __init__(self, root: Optional[str], imgsz: int = 224, nc: int = 4,
                 n_synth: int = 64, seed: int = 0, noise_seed: Optional[int] = None):
        self.imgsz = imgsz
        self.items: List = []
        self.folder = bool(root) and Path(root).is_dir()
        if self.folder:
            classes = sorted(d.name for d in Path(root).iterdir() if d.is_dir())
            self.names = {i: c for i, c in enumerate(classes)}
            for ci, c in enumerate(classes):
                for f in sorted((Path(root) / c).glob("*")):
                    self.items.append((str(f), ci))
        else:  # per class a hue; per image noise around it
            self.names = {i: str(i) for i in range(nc)}
            rng = np.random.default_rng(seed)
            hues = rng.uniform(0, 255, (nc, 3))
            nrng = np.random.default_rng(noise_seed) if noise_seed is not None else rng
            for i in range(n_synth):
                ci = i % nc
                img = np.clip(hues[ci] + nrng.normal(0, 30, (imgsz, imgsz, 3)),
                              0, 255).astype(np.uint8)
                self.items.append((img, ci))

    def __len__(self):
        return len(self.items)

    def load(self, idx: List[int]) -> List[np.ndarray]:
        """The BGR uint8 images of items `idx`: files decoded together on
        the decoder's threads and resized to imgsz x imgsz."""
        if not self.folder:
            return [self.items[i][0] for i in idx]
        files = [self.items[i][0] for i in idx]
        out = []
        for f, img in zip(files, native.decode_batch(files)):
            if isinstance(img, native.DecodeError):
                raise img
            out.append(resize_linear(img, (self.imgsz, self.imgsz)))
        return out

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Full batches {img (b, imgsz, imgsz, 3) RGB float32 in [0, 1],
        label (b,) int32}, shuffled by `seed`; the tail is dropped."""
        idx = np.arange(len(self.items))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for s in range(0, len(idx) - batch_size + 1, batch_size):
            sel = idx[s:s + batch_size]
            imgs = np.stack([np.asarray(im, np.float32) / 255.0 for im in self.load(sel)])
            labels = np.asarray([self.items[i][1] for i in sel], np.int32)
            yield {"img": imgs[..., ::-1].copy(), "label": labels}


def split_datasets(args, nc: int):
    """(train, val) datasets by JAX's rules (see the module's text)."""
    data = args.data if args.data not in SYNTH else None
    if data and (Path(data) / "train").is_dir():
        ds = ClassificationDataset(str(Path(data) / "train"), imgsz=args.imgsz, nc=nc)
        vroot = Path(data) / "val"
        val = ClassificationDataset(str(vroot), imgsz=args.imgsz, nc=nc) \
            if vroot.is_dir() else ds
        return ds, val
    if data:
        ds = ClassificationDataset(data, imgsz=args.imgsz, nc=nc)
        return ds, ds
    return (ClassificationDataset(None, imgsz=args.imgsz, nc=nc, seed=args.seed),
            ClassificationDataset(None, imgsz=args.imgsz, nc=nc, seed=args.seed,
                                  noise_seed=args.seed + 9991))


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions on the card while the block runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _to_device(batch: Dict[str, np.ndarray], device: torch.device):
    return (torch.from_numpy(batch["img"]).to(device, non_blocking=True),
            torch.from_numpy(batch["label"]).long().to(device, non_blocking=True))


class ClassificationTrainer(CallbackMixin):
    """`ClassificationTrainer(model, overrides=None, save_dir=None)`, then
    `train()`: see the module's text. `model` is a `ClassificationModel`
    (built from `model`, by default `yolov8n-cls.yaml`, on `device` where
    it is None); `overrides` are configuration keys, checked by `get_cfg`."""

    def __init__(self, model=None, overrides: Optional[Dict] = None, save_dir=None):
        over = dict(overrides or {})
        if save_dir is not None:
            over["save_dir"] = str(save_dir)
        self.args = get_cfg(None, over)
        self.init_callbacks()
        if model is None:
            model = ClassificationModel(self.args.model or "yolov8n-cls.yaml",
                                        device=parse_device(self.args.device))
        self.model = model
        self.device = model.device
        self.save_dir = Path(self.args.save_dir) if getattr(self.args, "save_dir", None) \
            else None
        self.train_ds, self.val_ds = split_datasets(self.args, model.nc)
        a = self.args
        self.steps_per_epoch = spe = max(len(self.train_ds) // a.batch, 1)
        keys = flax_keys(model)
        named = dict(model.named_parameters())
        self.optimizer = Optimizer(
            {keys[n]: p for n, p in named.items()}, a.optimizer or "auto", a.lr0, a.lrf,
            a.momentum, a.weight_decay, warmup_steps=int(a.warmup_epochs * spe),
            total_steps=spe * a.epochs, steps_per_epoch=spe, epochs=a.epochs,
            cos_lr=bool(a.cos_lr), warmup_momentum=a.warmup_momentum, nc=model.nc,
            warmup_bias_lr=a.warmup_bias_lr)
        self.ema = EMA(named)
        self.validator = ClassificationValidator(self.args)
        self.epoch_results: List[Dict[str, float]] = []
        self.losses: List[torch.Tensor] = []

    def train_step(self, img: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """One step on a batch on the device: float32 cross-entropy of the
        training logits, backward, the optimizer, the EMA. Returns the loss
        (a device tensor)."""
        self.model.train()
        loss = F.cross_entropy(self.model(img).float(), label)
        loss.backward()
        params = self.optimizer.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        self.optimizer.step(grads)
        self.ema.update(params)
        for p in params:
            p.grad = None
        return loss.detach()

    def ema_model(self):
        """A copy of the model holding the EMA parameters and the current
        BatchNorm statistics, in eval mode."""
        vm = copy.deepcopy(self.model).eval()
        ema = self.ema.state()
        with torch.no_grad():
            for name, p in vm.named_parameters():
                p.copy_(ema[name])
        return vm

    def train(self) -> Dict[str, float]:
        """All epochs; returns the best epoch's {top1, top5, best_top1}."""
        a = self.args
        best_top1, best, best_res = -1.0, None, None
        with no_tf32():
            for epoch in range(a.epochs):
                self.epoch = epoch
                losses = [self.train_step(*_to_device(b, self.device))
                          for b in self.train_ds.batches(a.batch, seed=a.seed + epoch)]
                self.losses.extend(losses)
                vm = self.ema_model()
                res = self.validator(vm, dataset=self.val_ds)
                self.epoch_results.append(res)
                mean = float(torch.stack(losses).mean()) if losses else float("nan")
                LOGGER.info(f"epoch {epoch + 1}/{a.epochs} loss {mean:.4f} "
                            f"top1 {res['top1']:.3f}")
                if res["top1"] >= best_top1:
                    best_top1, best, best_res = res["top1"], vm, res
                    self.best_epoch = epoch
                    self.save_checkpoint(vm, "best")
            if a.epochs:
                self.save_checkpoint(vm, "last")
        if best is not None:  # the model ends holding the best epoch's weights
            self.model.load_state_dict(best.state_dict())
        self.model.eval()
        res = dict(best_res or {"top1": 0.0, "top5": 0.0})
        res["best_top1"] = best_top1
        return res

    def save_checkpoint(self, model, name: str) -> Optional[Path]:
        """`<save_dir>/weights/<name>.npz` of `model` with its metadata."""
        if self.save_dir is None:
            return None
        meta = {"imgsz": self.args.imgsz, "nc": model.nc, "stride": list(model.stride),
                "names": {str(k): str(v) for k, v in model.names.items()},
                "model_yaml": model.model_yaml or "", "task": "classify",
                "epoch": self.epoch, "layout": "NHWC", "output": "(1, nc) probabilities"}
        return save_npz(model, self.save_dir / "weights" / f"{name}.npz", meta)


class ClassificationValidator(CallbackMixin):
    """`ClassificationValidator(args)(model, dataset=None)` -> {top1, top5}
    over the full batches of `dataset` (by default the `data` folder, or
    the synthetic split of `seed` 0), the eval forward in float32 on the
    model's device."""

    def __init__(self, args=None):
        self.args = args if hasattr(args, "imgsz") else get_cfg(None, args)
        self.init_callbacks()

    @torch.no_grad()
    def __call__(self, model, dataset=None) -> Dict[str, float]:
        a = self.args
        ds = dataset or ClassificationDataset(a.data if a.data not in SYNTH else None,
                                              imgsz=a.imgsz, nc=model.nc)
        was_training = model.training
        model.eval()
        top1 = top5 = n = 0
        with no_tf32():
            for batch in ds.batches(a.batch, shuffle=False):
                probs = model(_to_device(batch, model.device)[0]).float().cpu().numpy()
                order = np.argsort(-probs, axis=-1)
                top1 += (order[:, 0] == batch["label"]).sum()
                top5 += (order[:, :5] == batch["label"][:, None]).any(-1).sum()
                n += len(batch["label"])
        model.train(was_training)
        res = {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1)}
        LOGGER.info(f"classify val: top1 {res['top1']:.3f} top5 {res['top5']:.3f}")
        return res


class ClassificationPredictor(CallbackMixin):
    """`ClassificationPredictor(args)`, `setup_model(model)`, then
    `predictor(source, stream=False, batch=1)`: a `Results` with `probs`
    (float32) per image of `source` (the port's `load_inference_source`:
    numpy BGR images, files, directories, globs), `batch` images a
    forward."""

    def __init__(self, args=None, overrides: Optional[Dict] = None):
        self.args = args if hasattr(args, "imgsz") else get_cfg(None, {**(args or {}),
                                                                       **(overrides or {})})
        self.init_callbacks()
        self.model = None

    def setup_model(self, model):
        """Serve `model` (eval mode, float32, on its device; the `device`
        key, where set, must name it)."""
        if self.args.device is not None and \
                not names_device(parse_device(self.args.device), model.device):
            raise ValueError(f"the model is on {model.device}, the predictor's device is "
                             f"{self.args.device}")
        self.model = model.eval()
        return self

    def preprocess(self, imgs: List[np.ndarray]) -> torch.Tensor:
        """BGR uint8 images -> (b, imgsz, imgsz, 3) RGB float32 in [0, 1]."""
        s = int(self.args.imgsz)
        x = np.stack([resize_linear(im, (s, s))[..., ::-1] for im in imgs]).astype(np.float32)
        return torch.from_numpy(x / np.float32(255.0))

    @torch.no_grad()
    def stream_inference(self, source, batch: int = 1) -> Iterator[Results]:
        if self.model is None:
            raise RuntimeError("call setup_model(model) first")
        items = list(load_inference_source(source))
        with no_tf32():
            for s in range(0, len(items), max(int(batch), 1)):
                chunk = items[s:s + max(int(batch), 1)]
                x = self.preprocess([it["img"] for it in chunk]).to(self.model.device)
                probs = self.model(x).float().cpu().numpy()
                for it, p in zip(chunk, probs):
                    yield Results(it["img"], it["path"], self.model.names, probs=p)

    def __call__(self, source, stream: bool = False, batch: int = 1):
        gen = self.stream_inference(source, batch)
        return gen if stream else list(gen)
