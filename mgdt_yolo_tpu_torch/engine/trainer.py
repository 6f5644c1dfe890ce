"""Training engine: the JAX trainer's optimizer, step and loop in PyTorch
(`mgdt_yolo_tpu/engine/trainer.py`), on the synthetic scenes or a
YOLO-format dataset on disk (`data=`), with resume.

Augmentation is routed as JAX routes it (`check_augment_args`): the host
pipeline (`data.augment.train_transform`, run by the loader's threads) with
the JAX default `device_augment=False`, the device pipeline
(`ops/device_augment.py`, K3) with `device_augment=True`, except where a key
the device pipeline cannot honour is set (`degrees`, `shear`,
`perspective`, `mixup`, `copy_paste`, `mosaic9`): then JAX's warning is
logged and the host pipeline runs.

`check_train_args` holds the overrides to the JAX configuration's rules
before anything is built: an unknown key raises `SyntaxError` with the JAX
suggestions, a value of the wrong type as the JAX `check_cfg_types` does
(both checks are `cfg.check_dict_alignment` and `cfg.check_cfg_types`),
and a key the port does not honour yet (`label_smoothing`, `dropout`,
...) raises wherever it differs from the JAX default.

`Optimizer` is the JAX trainer's optax chain step for step: SGD (Nesterov)
or AdamW chosen as `optimizer="auto"` chooses, or RMSProp, gradients summed over
`accumulate` micro-batches (optax.MultiSteps, schedules indexed by optimizer
updates), then clipped to a global norm of 10, then weight decay on
conv/linear kernels only, with the bias group's learning rate warming down
from `warmup_bias_lr` while the others warm up from 0. The groups are read
from the parameters' flax names (`weights.flax_keys`), as the JAX trainer
reads them: BatchNorm's scale gets no decay and the main rate, every `bias`
(BatchNorm's included) the bias schedule. RMSProp is JAX's
`optax.rmsprop(lr_schedule, momentum=momentum)` after the same scaling and
clipping: optax's `scale_by_rms` (decay 0.9, eps 1e-8 inside the square
root), the rate, then a constant-momentum trace; no weight decay and no
bias group (not `torch.optim.RMSprop`, whose alpha is 0.99 and eps outside
the root).

The task follows the model's head (`DetectionModel.task`), as JAX's
`SegmentationTrainer` and `PoseTrainer` follow theirs: a segment or pose
model trains with `SegmentationLoss` or `PoseLoss` (`pose` and `kobj`
their gains), validates with `SegmentationValidator` or `PoseValidator`,
takes its synthetic scenes at the full `imgsz` with their masks or
keypoints, and always augments on the host (JAX's trainer runs its device
pipeline for the detect task only, and takes `device_augment=True`
silently there); `overlap_mask` and `mask_ratio`, which JAX's trainer
does not read, stay refused at other values.

`Trainer` runs micro-batches (the host pipeline's batches, or raw uint8
batches augmented on the device first; mosaic closed for the last
`close_mosaic` epochs: on the host from that epoch (none when
`close_mosaic` exceeds `epochs`, as in JAX), on the device from that
micro-step; the forward in
bf16 autocast on the GPU with float32 parameters, the loss in float32),
keeps an EMA of the parameters that advances only on batches that stepped
the optimizer, and after every epoch validates with the EMA parameters and
the current BatchNorm statistics, writes `results.csv`, `weights/last.npz`
and, by fitness, `weights/best.npz`, and stops early on a fitness plateau.
Each checkpoint also writes `<name>_resume.npz`, the state a resume needs
(raw parameters, batch statistics, EMA, optimizer moments); `resume=True`
carries on the newest `*/weights/last` under `project` at its next epoch.

`train` fires the JAX trainer's 9 hooks at its points (`add_callback`,
`utils/callbacks.py`) with JAX's loggers attached first
(`utils/callbacks_integrations.py`: `events.jsonl` and the optional
TensorBoard, MLflow and wandb ones, all writing under `save_dir`); with
`plots` and a `save_dir` it draws `labels.jpg` and `train_batch0.jpg`
before the first epoch, from a batch taken from the loader as JAX takes
one, and the validator draws its first batch and the confusion matrix.
"""
from __future__ import annotations

import copy
import logging
import math
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..cfg import check_cfg_types, check_dict_alignment
from ..cfg.default import CFG_DEFAULTS, NEUTRAL_KEYS, PORTED_OPTIMIZERS, TRAIN_DEFAULTS
from ..data.build import DataLoader, to_device
from ..data.synthetic import SyntheticDetectionDataset, synthetic_size, val_dataset
from ..device import names_device
from ..ops.device_augment import apply_augment, augment_draws
from ..utils.callbacks import CallbackMixin
from ..utils.loss import DetectionLoss
from ..utils.loss_seg_pose import PoseLoss, SegmentationLoss
from ..weights import flax_keys, save_npz
from .validator import DetectionValidator
from .validator_seg_pose import PoseValidator, SegmentationValidator

LOGGER = logging.getLogger(__name__)
DECAY_LEAVES = ("kernel", "weight", "reduction_weight")
MAX_GRAD_NORM = 10.0
CSV_KEYS = ("epoch", "box_loss", "cls_loss", "dfl_loss", "precision", "recall", "map50",
            "map", "fitness")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """The JAX trainer's `build_optimizer` chain over named tensors.

    `params` maps flax-style names (the last component decides the group)
    to the tensors to update. `step(grads)` takes one micro-batch's
    gradients and returns whether the parameters were updated.
    """

    def __init__(self, params: Mapping[str, torch.Tensor], name: str, lr0: float,
                 lrf: float, momentum: float, weight_decay: float, warmup_steps: int,
                 total_steps: int, steps_per_epoch: int, epochs: int, cos_lr: bool,
                 warmup_momentum: float, nc: int = 80, warmup_bias_lr: float = 0.1,
                 accumulate: int = 1):
        if name == "auto":
            if total_steps > 10000:
                name, lr0, momentum = "SGD", 0.01, 0.9
            else:
                name, lr0, momentum = "AdamW", round(0.002 * 5 / (4 + nc), 6), 0.9
        if name in ("SGD", "sgd"):
            self.kind = "sgd"
        elif name in ("AdamW", "Adam", "adamw", "adam", "NAdam", "RAdam"):
            self.kind = "adam"     # the JAX chain takes all of these as AdamW
        elif name == "RMSProp":
            self.kind = "rmsprop"
        else:
            raise ValueError(f"optimizer {name!r} is not ported")
        self.name, self.lr0, self.lrf, self.momentum = name, lr0, lrf, momentum
        self.weight_decay, self.cos_lr, self.epochs = weight_decay, cos_lr, epochs
        self.warmup_momentum, self.warmup_bias_lr = warmup_momentum, warmup_bias_lr
        self.accumulate = max(int(accumulate), 1)
        self.spe = max(steps_per_epoch // self.accumulate, 1)
        self.nw = max(warmup_steps // self.accumulate, 1)

        self.names, self.params = list(params), list(params.values())
        leaves = [n.rsplit(".", 1)[-1] for n in self.names]
        self.decay = [i for i, (leaf, p) in enumerate(zip(leaves, self.params))
                      if leaf in DECAY_LEAVES and p.dim() > 1]
        self.bias = [i for i, leaf in enumerate(leaves) if leaf == "bias"]
        self.main = sorted(set(range(len(leaves))) - set(self.bias))
        self.count = 0        # optimizer updates made; the schedules' index
        self.mini_step = 0    # micro-batches accumulated toward the next update

        def zeros():
            return [torch.zeros_like(p) for p in self.params]
        self.acc = zeros() if self.accumulate > 1 else None
        self.mu = zeros()     # SGD / RMSProp trace, Adam first moment
        self.nu = zeros() if self.kind in ("adam", "rmsprop") else None

    def hyperparams(self) -> Dict[str, float]:
        """lr, bias_lr and momentum of the next update."""
        n = self.count
        x = math.floor(n / self.spe) / max(self.epochs, 1)
        if self.cos_lr:
            lf = ((1 - math.cos(x * math.pi)) / 2) * (self.lrf - 1) + 1
        else:
            lf = (1 - x) * (1.0 - self.lrf) + self.lrf
        w = min(max(n / self.nw, 0.0), 1.0)
        return {"lr": self.lr0 * lf * w,
                "bias_lr": self.warmup_bias_lr * (1.0 - w) + self.lr0 * lf * w,
                "momentum": self.warmup_momentum + (self.momentum - self.warmup_momentum) * w}

    @torch.no_grad()
    def step(self, grads) -> bool:
        grads = list(grads)
        if self.acc is not None:
            # MultiSteps keeps the running mean of the micro-batch gradients
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            if self.mini_step < self.accumulate - 1:
                self.mini_step += 1
                return False
            grads, self.mini_step = self.acc, 0
        self._update(grads)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        self.count += 1
        return True

    def state(self) -> Dict[str, list]:
        """The tensors of the optimizer's state, by kind (`mu`, `nu`, `acc`,
        each a list in the parameters' order, absent where unused)."""
        return {k: v for k, v in (("mu", self.mu), ("nu", self.nu), ("acc", self.acc))
                if v is not None}

    def _update(self, grads):
        h = self.hyperparams()
        u = torch._foreach_mul(grads, float(self.accumulate))
        norm = global_norm(u)
        torch._foreach_mul_(u, torch.where(norm < MAX_GRAD_NORM, 1.0, MAX_GRAD_NORM / norm))
        dec = self.decay
        if self.kind == "rmsprop":
            # scale_by_rms: nu = (1 - 0.9) g^2 + 0.9 nu, g * rsqrt(nu + eps);
            # then -lr, then the trace mu = u + momentum mu
            torch._foreach_mul_(self.nu, 0.9)
            torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(u, u), 0.1))
            den = torch._foreach_add(self.nu, 1e-8)
            torch._foreach_rsqrt_(den)
            torch._foreach_mul_(u, den)
            torch._foreach_mul_(u, -h["lr"])
            torch._foreach_mul_(self.mu, self.momentum)
            torch._foreach_add_(self.mu, u)
            torch._foreach_add_(self.params, self.mu)
            return
        if self.kind == "sgd":
            if dec:
                torch._foreach_add_([u[i] for i in dec], [self.params[i] for i in dec],
                                    alpha=self.weight_decay)
            m = h["momentum"]
            torch._foreach_mul_(self.mu, m)
            torch._foreach_add_(self.mu, u)
            torch._foreach_add_(u, self.mu, alpha=m)          # Nesterov
        else:
            b1, b2, c = self.momentum, 0.999, self.count + 1
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, u, alpha=1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, u, u, value=1 - b2)
            # bias corrections 1 - b**c in float32, as optax takes them
            bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(c)) for b in (b1, b2))
            den = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, 1e-8)
            u = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
            if dec:
                torch._foreach_add_([u[i] for i in dec], [self.params[i] for i in dec],
                                    alpha=self.weight_decay)
        for group, lr in ((self.main, h["lr"]), (self.bias, h["bias_lr"])):
            if group:
                torch._foreach_add_([self.params[i] for i in group], [u[i] for i in group],
                                    alpha=-lr)


class EMA:
    """Exponential moving average of named parameters; the decay ramps as
    0.9999 * (1 - exp(-n / 2000)) over the n updates made so far."""

    def __init__(self, params: Mapping[str, torch.Tensor], decay: float = 0.9999):
        self.names = list(params)
        self.values = [p.detach().clone() for p in params.values()]
        self.decay, self.updates = decay, 0

    @torch.no_grad()
    def update(self, params):
        self.updates += 1
        n = torch.tensor(-float(self.updates), dtype=torch.float32)
        d = float(self.decay * (1 - torch.exp(n / 2000.0)))
        torch._foreach_mul_(self.values, d)
        torch._foreach_add_(self.values, [p.detach() for p in params], alpha=1.0 - d)

    def state(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.values))


def device_augment_unsupported(args: Mapping) -> Dict[str, float]:
    """The augmentation keys the device pipeline cannot honour, where set:
    full random perspective, mixup, copy-paste and the 3x3 mosaic; the
    trainer takes the host pipeline for them, as JAX's does."""
    return {k: args.get(k, 0) for k in
            ("degrees", "shear", "perspective", "mixup", "copy_paste", "mosaic9")
            if args.get(k, 0)}


class EarlyStopping:
    """Stop when fitness has not risen for `patience` epochs (0: never)."""

    def __init__(self, patience: int = 50):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info(f"EarlyStopping: no improvement in last {self.patience} "
                        f"epochs (best epoch {self.best_epoch})")
        return stop


def uses_device_augment(a: Mapping, task: str = "detect") -> bool:
    """Whether the device pipeline runs: the detect task, `device_augment`
    set and no key it cannot honour."""
    return task == "detect" and bool(a["device_augment"]) and not device_augment_unsupported(a)


def check_augment_args(a: Mapping, task: str = "detect") -> bool:
    """JAX's routing: True where the device pipeline runs. With
    `device_augment=True` and a key it cannot honour set, JAX's warning is
    logged and the host pipeline runs (False); the segment and pose tasks
    take the host pipeline without a word, as JAX's trainers do."""
    if task != "detect":
        return False
    if a["device_augment"] and not uses_device_augment(a):
        LOGGER.warning(f"device_augment=True cannot honor {device_augment_unsupported(a)} — "
                       "falling back to the host augmentation pipeline")
    return uses_device_augment(a)


def _unhonoured_reason(key: str, device) -> str:
    if key == "optimizer":
        return f"optimizer must be one of {PORTED_OPTIMIZERS}"
    if key == "device":
        return f"device must name the model's device, {device}"
    if key == "save_dir":
        return "save_dir is the Trainer's own argument"
    return f"{key} must be {CFG_DEFAULTS[key]!r} (the JAX default)"


def check_train_args(overrides: Optional[Mapping], device: Optional[torch.device] = None
                     ) -> Dict:
    """The trainer's arguments, `TRAIN_DEFAULTS` updated by `overrides`, after
    holding `overrides` to the JAX configuration: its keys (and `save_dir`,
    which the JAX `get_cfg` also takes), its value types, and, for a key the
    port does not honour, its default. `device`, where given, is the
    model's, which a `device` key must name."""
    overrides = dict(overrides or {})
    check_dict_alignment({**CFG_DEFAULTS, "save_dir": None}, overrides)
    check_cfg_types({**CFG_DEFAULTS, **TRAIN_DEFAULTS, **overrides})
    unhonoured = {k: v for k, v in overrides.items()
                  if k not in TRAIN_DEFAULTS and k not in NEUTRAL_KEYS
                  and v != CFG_DEFAULTS.get(k)}
    if overrides.get("optimizer", "auto") not in PORTED_OPTIMIZERS:
        unhonoured["optimizer"] = overrides["optimizer"]
    if device is not None and overrides.get("device") is not None and \
            not names_device(overrides["device"], device):
        unhonoured["device"] = overrides["device"]
    if unhonoured:
        raise ValueError(f"the port does not honour {unhonoured} yet: " +
                         "; ".join(_unhonoured_reason(k, device) for k in unhonoured))
    return {**TRAIN_DEFAULTS, **overrides}


def check_rebuildable(model) -> None:
    """Raise unless a checkpoint of `model` can name the config that rebuilds
    it: a model built from a dict of no file records none, and `from_npz`
    would rebuild another model from its weights."""
    if model.model_yaml is None:
        raise ValueError("the model was built from a config dict that names no YAML file, "
                         "so its checkpoint could not be loaded back; build it by file name "
                         "(models.CONFIGS) to save checkpoints")


def dataset_dict(data, model=None) -> Dict:
    """`check_det_dataset(data)`, its `names` set on `model` (whose `nc`
    must be theirs), as the JAX trainer sets them."""
    from ..data.utils import check_det_dataset
    d = check_det_dataset(data)
    if model is not None and d.get("names"):
        names = {int(k): str(v) for k, v in d["names"].items()}
        if len(names) != model.nc:
            raise ValueError(f"the dataset {data!r} names {len(names)} classes and the model "
                             f"has nc={model.nc}")
        model.names = names
    return d


def get_dataset(args: Mapping, train: bool = True, model=None):
    """The JAX trainer's `get_dataset`: the synthetic scenes for `data` None
    or "synthetic" (64 train / 16 validation scenes at min(imgsz, 320) px,
    the full imgsz with their masks or keypoints for a segment or pose
    model, from `seed` / `seed + 1`), else the `train` or `val` split of a
    dataset YAML or directory as a `YOLODataset` (`dataset_dict` sets its
    names on `model`). A YOLO dataset on disk has boxes only, as JAX's
    `YOLODataset` reads them, so a segment or pose model refuses one (JAX's
    loss would find no masks or keypoints in its batches)."""
    data = args.get("data")
    task = getattr(model, "task", "detect")
    if data in (None, "synthetic", "synthetic.yaml"):
        nc = model.nc if model is not None else 2
        if not train:
            return val_dataset(args["imgsz"], nc, args["seed"], task)
        return SyntheticDetectionDataset(n=64, imgsz=synthetic_size(args["imgsz"], task),
                                         nc=nc, seed=args["seed"], task=task)
    if task != "detect":
        raise ValueError(f"a {task} model trains and validates on the synthetic scenes only: "
                         f"the YOLO dataset {data!r} has boxes and no "
                         f"{'masks' if task == 'segment' else 'keypoints'}, as JAX's "
                         "YOLODataset reads it")
    from ..data.dataset import YOLODataset
    d = dataset_dict(data, model)
    split = d.get("train" if train else "val") or d.get("val") or d.get("train")
    return YOLODataset(str(split), cache=args.get("cache", False),
                       single_cls=args.get("single_cls", False),
                       fraction=args.get("fraction", 1.0) if train else 1.0,
                       workers=args.get("workers", 8))


def build_loader(args: Mapping, train: bool = True, model=None) -> DataLoader:
    """The loader the JAX trainer builds over `get_dataset`: batch `batch`,
    seeded, the train split augmented on the device or the host as
    `uses_device_augment` routes it, with `args` as its hyperparameters; the
    validation split in rectangular batches with `rect`, aligned to the
    model's largest stride, as the JAX validator builds it."""
    ds = get_dataset(args, train, model)
    stride = int(max(model.stride)) if model is not None else 32
    task = getattr(model, "task", "detect")
    return DataLoader(ds, args["batch"], args["imgsz"], seed=args["seed"], train=train,
                      device_augment=uses_device_augment(args, task) and train, hyp=args,
                      workers=args.get("workers", 8), rect=bool(args.get("rect")) and not train,
                      stride=stride)


VALIDATORS = {"detect": DetectionValidator, "segment": SegmentationValidator,
              "pose": PoseValidator}


def build_criterion(model, a: Mapping):
    """The loss of the model's task with the trainer's gains, as JAX's
    trainers build theirs (`get_criterion`)."""
    gains = {"box_gain": a["box"], "cls_gain": a["cls"], "dfl_gain": a["dfl"]}
    task = getattr(model, "task", "detect")
    if task == "segment":
        return SegmentationLoss(model.nc, model.reg_max, model.stride, **gains)
    if task == "pose":
        return PoseLoss(model.nc, model.reg_max, model.stride, kpt_shape=model.kpt_shape,
                        pose_gain=a["pose"], kobj_gain=a["kobj"], **gains)
    return DetectionLoss(model.nc, model.reg_max, model.stride, **gains)


def resume_state_path(npz) -> Path:
    """Where the resume state of the checkpoint `npz` is written."""
    npz = Path(npz)
    return npz.with_name(f"{npz.stem}_resume.npz")


class Trainer(CallbackMixin):
    """Trains a `DetectionModel` over a training `data.build.DataLoader`.

    `overrides` replace keys of `cfg.default.TRAIN_DEFAULTS` and are held to
    the JAX configuration first (`check_train_args`: an unknown key, a
    wrong type or a key the port does not honour raises); the loader's
    `device_augment` must match the routing (`check_augment_args`), and a
    host-path loader built without `hyp` takes the trainer's arguments.
    Without a `loader`, the train split of `data` is loaded
    (`build_loader`: the synthetic scenes when `data` is None). `steps_per_epoch` defaults to the loader's length. With
    `save_dir`, every epoch writes `<save_dir>/results.csv` and
    `weights/last.npz` (EMA parameters, current batch statistics) with its
    resume state, and `weights/best.npz` when its fitness is the best so
    far. Validation runs on `val_loader`, by default the `val` split of
    `data` (the JAX trainer's synthetic validation set when it is None).
    `augment_fn(batch, step)` replaces the default device augmentation,
    which draws from a generator seeded from (`seed`, step); on the host
    path there is none unless given. With
    `resume=True`, the newest `*/weights/last` under `project` is restored
    here (`load_resume`) and training carries on at its next epoch. The
    validation runs in bf16 exactly where the training does (`amp` on the
    card), passed to the validator as its `half`.
    """

    def __init__(self, model, loader=None, overrides: Optional[Dict] = None,
                 save_dir=None, steps_per_epoch: Optional[int] = None, val_loader=None,
                 augment_fn: Optional[Callable] = None):
        self.args = a = check_train_args(overrides,
                                         None if model is None else model.device)
        self.init_callbacks()
        self.task = getattr(model, "task", "detect")
        self.device_augment = check_augment_args(a, self.task)
        if loader is not None and loader.device_augment != self.device_augment:
            raise ValueError(f"the loader's device_augment={loader.device_augment} does not "
                             f"match the trainer's, {self.device_augment} (device_augment="
                             f"{a['device_augment']}, unsupported on the device: "
                             f"{device_augment_unsupported(a) or 'none'})")
        if loader is None:
            loader = build_loader(a, True, model)
        else:
            if loader.hyp is None:
                loader.set_hyp(a)
            if a["data"] not in (None, "synthetic", "synthetic.yaml"):
                dataset_dict(a["data"], model)
        self.model, self.loader, self.val_loader = model.train(), loader, val_loader
        self.device = model.device
        self.save_dir = Path(save_dir) if save_dir is not None else None
        if self.save_dir is not None:
            check_rebuildable(model)
        nb = steps_per_epoch or len(loader)
        self.accumulate = max(round(a["nbs"] / a["batch"]), 1)
        wd = a["weight_decay"] * a["batch"] * self.accumulate / a["nbs"]
        keys = flax_keys(model)
        named = dict(model.named_parameters())
        self.optimizer = Optimizer(
            {keys[n]: p for n, p in named.items()}, a["optimizer"], a["lr0"], a["lrf"],
            a["momentum"], wd, warmup_steps=max(round(a["warmup_epochs"] * nb), 100),
            total_steps=nb * a["epochs"], steps_per_epoch=nb, epochs=a["epochs"],
            cos_lr=a["cos_lr"], warmup_momentum=a["warmup_momentum"], nc=model.nc,
            warmup_bias_lr=a["warmup_bias_lr"], accumulate=self.accumulate)
        self.criterion = build_criterion(model, a)
        self.ema = EMA(named)
        self.step = 0         # micro-batches taken: drives the assigner's anneal
        self.epoch = 0
        self.start_epoch = 0  # the first epoch `train` runs (after a resume, the next one)
        self.amp = bool(a["amp"]) and self.device.type == "cuda"
        # close_mosaic on the device as a step threshold: mosaic off from this
        # micro-step on (the host path closes it by epoch, in `train`)
        self.mosaic_off_step = ((a["epochs"] - a["close_mosaic"]) * nb
                                if a["close_mosaic"] and self.device_augment else None)
        self.augment_fn = augment_fn or (self.augment if self.device_augment else None)
        self.draws = None     # the default augmentation's last draws
        self.history = []     # every micro-step's metrics (device tensors)
        self.metrics = {}     # the last validation's results
        self.best_fitness = 0.0
        self.stopper = EarlyStopping(a["patience"])
        self.validator = self._val_model = None
        self.resume_path = None
        if a["resume"]:
            found = self.find_resume_checkpoint()
            if found is not None:
                self.load_resume(found)

    def find_resume_checkpoint(self) -> Optional[Path]:
        """The newest `*/weights/last.npz` with a resume state under
        `project` (runs/detect by default), as the JAX trainer finds its
        `*/weights/last`; None, with a warning, where there is none."""
        root = Path(self.args.get("project") or "runs/detect")
        cands = sorted((p for p in root.glob("*/weights/last.npz")
                        if resume_state_path(p).is_file()),
                       key=lambda p: resume_state_path(p).stat().st_mtime, reverse=True)
        if not cands:
            LOGGER.warning("resume requested but no checkpoint found")
            return None
        return cands[0]

    @torch.no_grad()
    def load_resume(self, npz) -> None:
        """Restore the checkpoint `npz`'s training state: raw and EMA
        parameters, batch statistics, the optimizer's moments, accumulation
        and count, `step`, `ema_updates`, `epoch` (training carries on at
        the next) and `best_fitness`. The model must be pinned to the deform
        semantics the checkpoint was trained under, or this raises, as the
        JAX trainer refuses to flip kernels mid-run."""
        from ..weights import read_metadata
        meta = read_metadata(npz)
        sem = meta.get("deform_semantics")
        if sem in ("exact", "windowed") and sem != self.model.deform_semantics:
            raise RuntimeError(
                f"resume: the checkpoint {npz} was trained with {sem.upper()} deform semantics "
                f"and the model is pinned to {self.model.deform_semantics!r}; refusing to flip "
                f"kernels mid-run: set_deform_semantics({sem!r}) or train from scratch")
        opt = meta.get("optimizer", {})
        if opt.get("kind") != self.optimizer.kind or \
                opt.get("accumulate") != self.optimizer.accumulate:
            raise ValueError(f"resume: the checkpoint's optimizer {opt} is not this run's "
                             f"({self.optimizer.kind}, accumulate {self.optimizer.accumulate})")
        with np.load(str(resume_state_path(npz))) as f:
            for k, t in self.train_state().items():
                t.copy_(torch.from_numpy(f[k]))
        self.optimizer.count, self.optimizer.mini_step = opt["count"], opt["mini_step"]
        self.step, self.ema.updates = int(meta["step"]), int(meta["ema_updates"])
        self.epoch = int(meta["epoch"])
        self.start_epoch = self.epoch + 1
        self.best_fitness = float(meta.get("best_fitness", 0.0))
        self.resume_path = Path(npz)
        LOGGER.info(f"resumed from {npz} at epoch {self.start_epoch} (step {self.step}, "
                    f"fitness {self.best_fitness:.4f})")

    def train_state(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the training state, by name, as `<name>_resume.npz`
        holds them: `param/`, `buffer/` and `ema/` by the model's names, and
        the optimizer's `mu/`, `nu/` and `acc/` by its parameters' names."""
        m = self.model
        state = {f"param/{n}": p for n, p in m.named_parameters()}
        state.update({f"buffer/{n}": b for n, b in m.named_buffers()})
        state.update({f"ema/{n}": e for n, e in zip(self.ema.names, self.ema.values)})
        names = [n for n, _ in m.named_parameters()]
        for kind, tensors in self.optimizer.state().items():
            state.update({f"{kind}/{n}": t for n, t in zip(names, tensors)})
        return state

    def augment(self, batch: Dict[str, torch.Tensor], step: int):
        """The default `augment_fn`: draws seeded from (seed, step), mosaic
        with probability `mosaic` until the close-mosaic step, then 0."""
        a = self.args
        closed = self.mosaic_off_step is not None and step >= self.mosaic_off_step
        gen = torch.Generator().manual_seed(a["seed"] * 1000003 + step)
        self.draws = augment_draws(
            batch["img"].shape[0], a["imgsz"], gen, 0.0 if closed else a["mosaic"],
            a["scale"], a["translate"], a["fliplr"], a["flipud"], a["hsv_h"], a["hsv_s"],
            a["hsv_v"])
        return apply_augment(batch, self.draws, a["imgsz"], batch["gt_bboxes"].shape[1])

    def train_step(self, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One micro-batch: augmentation (when the trainer has an
        `augment_fn`), forward, loss, backward, optimizer (every
        `accumulate`-th call) and EMA. Returns loss, box, cls, dfl and the
        micro-batch's gradient norm, as device tensors. `mark(name)`, if
        given, is called after each of "augment", "forward", "loss",
        "backward" and "optimizer" (the profiling tool records CUDA events
        there; the gradients are still set at "backward")."""
        mark = mark or (lambda name: None)
        if self.augment_fn is not None:
            batch = self.augment_fn(batch, self.step)
        mark("augment")
        img = batch["img"]
        if not img.is_floating_point():
            img = img.float() / 255.0
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.amp):
            feats = self.model.forward_feats(img)
        mark("forward")
        out = self.criterion(feats, batch, self.step)
        mark("loss")
        out.total.backward()
        mark("backward")
        params = self.optimizer.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = global_norm(grads)
        if self.optimizer.step(grads):
            self.ema.update(params)
        for p in params:
            p.grad = None
        mark("optimizer")
        self.step += 1
        # parts: detect [box, cls, dfl], segment [box, seg, cls, dfl],
        # pose [box, kpt, kobj, cls, dfl]
        return {"loss": out.total.detach(), "box": out.parts[0], "cls": out.parts[-2],
                "dfl": out.parts[-1], "grad_norm": grad_norm}

    def train(self) -> Dict[str, float]:
        """All epochs over the loader, as the JAX trainer's loop runs them,
        firing its hooks at its points (the loggers of
        `utils.callbacks_integrations` attached first); returns the last
        validation's results."""
        from ..utils.callbacks_integrations import add_integration_callbacks
        add_integration_callbacks(self)
        self.run_callbacks("on_pretrain_routine_start")
        a = self.args
        self.run_callbacks("on_pretrain_routine_end")
        self.run_callbacks("on_train_start")
        if a["plots"] and self.save_dir is not None:
            self.plot_train_start()
        for epoch in range(self.start_epoch, a["epochs"]):
            self.epoch = epoch
            self.run_callbacks("on_train_epoch_start")
            self.loader.set_epoch(epoch)
            # JAX closes it at epoch `epochs - close_mosaic`, so never when
            # that is negative; a resume past it keeps it closed
            if a["close_mosaic"] and not self.device_augment and \
                    epoch >= a["epochs"] - a["close_mosaic"] >= 0 and \
                    self.loader.hyp.get("mosaic"):
                LOGGER.info("closing mosaic augmentation")
                self.loader.set_hyp({**self.loader.hyp, "mosaic": 0.0})
            # loss parts summed on the device; one host sync per epoch
            msum, seen = None, 0
            for batch in self.loader:
                m = self.train_step(to_device(batch, self.device))
                self.history.append(m)
                part = torch.stack([m["box"], m["cls"], m["dfl"]])
                msum = part if msum is None else msum + part
                seen += 1
                self.run_callbacks("on_train_batch_end")
            mloss = msum.cpu().numpy() / seen if msum is not None else np.zeros(3)
            self.loss_items = dict(zip(("box_loss", "cls_loss", "dfl_loss"), mloss))
            self.run_callbacks("on_train_epoch_end")
            fit = 0.0
            if a["val"]:
                self.metrics = self.validate()
                fit = self.metrics.get("fitness", 0.0)
            if self.save_dir is not None:
                self.save_metrics_csv(epoch, mloss, self.metrics)
            if a["save"]:
                is_best = fit >= self.best_fitness
                if is_best:
                    self.best_fitness = fit
                if self.save_dir is not None:
                    self.save_checkpoint("last")
                    if is_best:
                        self.save_checkpoint("best")
                    if a["save_period"] > 0 and epoch % a["save_period"] == 0:
                        self.save_checkpoint(f"epoch{epoch}")
                self.run_callbacks("on_model_save")
            self.run_callbacks("on_fit_epoch_end")
            LOGGER.info(f"epoch {epoch + 1}/{a['epochs']} box {mloss[0]:.4f} "
                        f"cls {mloss[1]:.4f} dfl {mloss[2]:.4f} fitness {fit:.4f}")
            if self.stopper(epoch, fit):
                break
        self.run_callbacks("on_train_end")
        return self.metrics

    def plot_train_start(self) -> None:
        """JAX's `_plot_train_start`: `labels.jpg` from the labels of up to
        1000 dataset items and `train_batch0.jpg` from the loader's first
        batch, which, as in JAX, is taken from the loader before training
        (`DataLoader.first_batch`: its items join the mosaic buffer). A
        failure is logged and training goes on, as in JAX. The seconds it
        took are kept in `plot_seconds`."""
        from ..utils.plotting import plot_images, plot_labels
        t0 = time.perf_counter()
        try:
            names = self.model.names or {}
            ds = self.loader.dataset
            rows = []
            for i in range(min(len(ds), 1000)):
                it = ds[i]
                h, w = it["img"].shape[:2]
                b = np.asarray(it["boxes"], np.float32).reshape(-1, 4)
                if len(b):
                    xywh = np.stack([(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                                     (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], -1)
                    rows.append((xywh, np.asarray(it["cls"]).ravel()))
            if rows:
                plot_labels(np.concatenate([r[0] for r in rows]),
                            np.concatenate([r[1] for r in rows]), names, str(self.save_dir))
            batch = self.loader.first_batch()
            if "img" in batch:
                boxes = [np.concatenate(
                    [batch["gt_bboxes"][j][batch["mask_gt"][j]],
                     np.ones((int(batch["mask_gt"][j].sum()), 1)),
                     batch["gt_labels"][j][batch["mask_gt"][j]][:, None]], 1)
                    for j in range(len(batch["img"]))]
                plot_images(batch["img"].astype(np.float32) / 255.0, boxes, names,
                            str(self.save_dir / "train_batch0.jpg"))
        except Exception as e:  # drawing must never end a run
            LOGGER.warning(f"train-start plots failed: {e}")
        self.plot_seconds = time.perf_counter() - t0

    def validate(self) -> Dict[str, float]:
        """Validate a copy of the model holding the EMA parameters and the
        current BatchNorm statistics."""
        if self.validator is None:
            a = self.args
            if self.val_loader is None:
                self.val_loader = build_loader(a, False, self.model)
            # predictions.json (save_json) and the plots land with the run,
            # as in JAX; bf16 exactly where the trainer's amp is
            self.validator = VALIDATORS[self.task]({**a, "save_dir": self.save_dir,
                                                    "half": self.amp})
            self._val_model = copy.deepcopy(self.model)
        vm, ema = self._val_model, self.ema.state()
        with torch.no_grad():
            for name, p in vm.named_parameters():
                p.copy_(ema[name])
            for (_, b), (_, src) in zip(vm.named_buffers(), self.model.named_buffers()):
                b.copy_(src)
        return self.validator(vm, self.val_loader)

    def save_metrics_csv(self, epoch: int, mloss, metrics: Mapping):
        """Append one row to `<save_dir>/results.csv` (header first)."""
        vals = [epoch, *[float(v) for v in mloss],
                *[metrics.get(k, 0) for k in CSV_KEYS[4:]]]
        csv = self.save_dir / "results.csv"
        header = not csv.exists()
        csv.parent.mkdir(parents=True, exist_ok=True)
        with open(csv, "a") as f:
            if header:
                f.write(",".join(CSV_KEYS) + "\n")
            f.write(",".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                             for v in vals) + "\n")

    def save_checkpoint(self, name: str = "last") -> Path:
        """`<save_dir>/weights/<name>.npz` (EMA parameters and the current
        batch statistics, flax keys), its metadata, which records the class
        names and the deform semantics the weights were trained under, and
        `<name>_resume.npz`, the rest of the training state
        (`train_state`)."""
        m, o = self.model, self.optimizer
        check_rebuildable(m)
        meta = {"imgsz": self.args["imgsz"], "nc": m.nc, "stride": list(m.stride),
                "names": {str(k): str(v) for k, v in m.names.items()},
                "model_yaml": m.model_yaml,
                "deform_semantics": m.deform_semantics, "layout": "NHWC",
                "output": "(1, 4+nc, A) xywh+scores", "epoch": self.epoch,
                "step": self.step, "ema_updates": self.ema.updates,
                "best_fitness": float(self.best_fitness),
                "optimizer": {"name": o.name, "kind": o.kind, "accumulate": o.accumulate,
                              "count": o.count, "mini_step": o.mini_step}}
        path = save_npz(m, self.save_dir / "weights" / f"{name}.npz", meta,
                        params=self.ema.state())
        np.savez(str(resume_state_path(path)),
                 **{k: v.detach().cpu().numpy() for k, v in self.train_state().items()})
        return path
