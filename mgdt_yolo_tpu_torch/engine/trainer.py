"""Training engine: the JAX trainer's optimizer, step and loop in PyTorch
(`mgdt_yolo_tpu/engine/trainer.py`), without validation, augmentation or
resume.

`Optimizer` is the JAX trainer's optax chain step for step: SGD (Nesterov)
or AdamW chosen as `optimizer="auto"` chooses, gradients summed over
`accumulate` micro-batches (optax.MultiSteps, schedules indexed by optimizer
updates), then clipped to a global norm of 10, then weight decay on
conv/linear kernels only, with the bias group's learning rate warming down
from `warmup_bias_lr` while the others warm up from 0. The groups are read
from the parameters' flax names (`weights.flax_keys`), as the JAX trainer
reads them: BatchNorm's scale gets no decay and the main rate, every `bias`
(BatchNorm's included) the bias schedule.

`Trainer` runs micro-batches (uint8 images normalised on the device, the
forward in bf16 autocast on the GPU with float32 parameters, the loss in
float32), keeps an EMA of the parameters that advances only on batches that
stepped the optimizer, and writes `weights/last.npz` with its metadata.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..cfg.default import TRAIN_DEFAULTS
from ..data.build import to_device
from ..utils.loss import DetectionLoss
from ..weights import flax_keys, save_npz

DECAY_LEAVES = ("kernel", "weight", "reduction_weight")
MAX_GRAD_NORM = 10.0


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
        self.mu = zeros()     # SGD trace / Adam first moment
        self.nu = zeros() if self.kind == "adam" else None

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

    def _update(self, grads):
        h = self.hyperparams()
        u = torch._foreach_mul(grads, float(self.accumulate))
        norm = global_norm(u)
        torch._foreach_mul_(u, torch.where(norm < MAX_GRAD_NORM, 1.0, MAX_GRAD_NORM / norm))
        dec = self.decay
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


class Trainer:
    """Trains a `DetectionModel` over a loader of collated batches
    (`data.build.DataLoader`) and writes `<save_dir>/weights/last.npz`
    after every epoch (EMA parameters, current batch statistics).

    `overrides` replace keys of `cfg.default.TRAIN_DEFAULTS`;
    `steps_per_epoch` defaults to the loader's length.
    """

    def __init__(self, model, loader=None, overrides: Optional[Dict] = None,
                 save_dir=None, steps_per_epoch: Optional[int] = None):
        self.args = a = {**TRAIN_DEFAULTS, **(overrides or {})}
        self.model, self.loader = model.train(), loader
        self.device = model.device
        self.save_dir = Path(save_dir) if save_dir is not None else None
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
        self.criterion = DetectionLoss(model.nc, model.reg_max, model.stride,
                                       box_gain=a["box"], cls_gain=a["cls"],
                                       dfl_gain=a["dfl"])
        self.ema = EMA(named)
        self.step = 0         # micro-batches taken: drives the assigner's anneal
        self.epoch = 0
        self.amp = bool(a["amp"]) and self.device.type == "cuda"

    def train_step(self, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One micro-batch: forward, loss, backward, optimizer (every
        `accumulate`-th call) and EMA. Returns loss, box, cls, dfl and the
        micro-batch's gradient norm, as device tensors. `mark(name)`, if
        given, is called after each of "forward", "loss", "backward" and
        "optimizer" (the profiling tool records CUDA events there)."""
        mark = mark or (lambda name: None)
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
        return {"loss": out.total.detach(), "box": out.parts[0], "cls": out.parts[1],
                "dfl": out.parts[2], "grad_norm": grad_norm}

    def train(self):
        """All epochs over the loader; returns every step's metrics."""
        history = []
        for epoch in range(self.args["epochs"]):
            self.epoch = epoch
            self.loader.set_epoch(epoch)
            for batch in self.loader:
                history.append(self.train_step(to_device(batch, self.device)))
            if self.save_dir is not None:
                self.save_checkpoint("last")
        return history

    def save_checkpoint(self, name: str = "last") -> Path:
        """`<save_dir>/weights/<name>.npz` (EMA parameters and the current
        batch statistics, flax keys) and its metadata, which records the
        deform semantics the weights were trained under."""
        m = self.model
        meta = {"imgsz": self.args["imgsz"], "nc": m.nc, "stride": list(m.stride),
                "names": {str(i): str(i) for i in range(m.nc)},
                "model_yaml": m.model_yaml,
                "deform_semantics": m.deform_semantics, "layout": "NHWC",
                "output": "(1, 4+nc, A) xywh+scores", "epoch": self.epoch,
                "step": self.step, "ema_updates": self.ema.updates}
        return save_npz(m, self.save_dir / "weights" / f"{name}.npz", meta,
                        params=self.ema.state())
