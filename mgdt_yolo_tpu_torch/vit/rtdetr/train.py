"""RT-DETR's trainer: the detect trainer's loop, optimizer, EMA and
checkpoints with the DETR loss; the counterpart of
`mgdt_yolo_tpu/vit/rtdetr/train.py`.

As JAX's `RTDETRTrainer`: mosaic is forced to 0 (whatever is asked), the
targets go to the loss and to the decoder's denoising group as normalised
xywh (the padded pixel boxes over `imgsz`), the denoising noise is drawn
fresh every step (here from a `torch.Generator` seeded by `seed` and the
step; `noise_fn(step)` replaces the draws), the loss is the plain sum of
its parts with no batch-size factor, and validation runs
`RTDETRValidator` on the EMA weights. The logged box / cls / dfl slots hold
the last layer's L1 box, class and GIoU losses, as JAX's metrics do.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ...engine.trainer import Trainer
from ...ops.boxes import xyxy2xywh
from ...utils.loss import LossOutputs
from ..utils.loss import RTDETRDetectionLoss
from .val import RTDETRValidator


class DETRCriterion:
    """`RTDETRDetectionLoss` called as the trainer calls a loss:
    (head output, batch, step) -> LossOutputs(total, [bbox, class, giou])."""

    def __init__(self, nc: int, imgsz: int):
        self.loss = RTDETRDetectionLoss(nc=nc)
        self.imgsz = float(imgsz)

    def targets(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The padded targets with the boxes as float32 xywh over `imgsz`."""
        return {"gt_bboxes_norm": xyxy2xywh(batch["gt_bboxes"].float()) / self.imgsz,
                "gt_labels": batch["gt_labels"], "mask_gt": batch["mask_gt"]}

    def __call__(self, head_out, batch: Dict[str, torch.Tensor], step: int) -> LossOutputs:
        total, parts = self.loss(head_out[:4], self.targets(batch), dn_meta=head_out[4])
        main = torch.stack([parts["loss_bbox"], parts["loss_class"], parts["loss_giou"]])
        return LossOutputs(total, main.detach())


class RTDETRTrainer(Trainer):
    """Trains an `RTDETRDetectionModel`; see the module's text and
    `engine.trainer.Trainer` for the arguments."""

    def __init__(self, model, loader=None, overrides: Optional[Dict] = None, save_dir=None,
                 steps_per_epoch: Optional[int] = None, val_loader=None,
                 noise_fn: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None):
        overrides = {**(overrides or {}), "mosaic": 0.0}
        super().__init__(model, loader, overrides, save_dir, steps_per_epoch, val_loader)
        self.noise_fn = noise_fn

    def get_criterion(self, model, a: Mapping):
        return DETRCriterion(model.nc, a["imgsz"])

    def get_validator(self, args: Mapping):
        return RTDETRValidator(args)

    def forward_train(self, img: torch.Tensor, batch: Dict[str, torch.Tensor]):
        """The training forward with this step's denoising group."""
        dn = self.criterion.targets(batch)
        if self.noise_fn is not None:
            dn["noise"] = self.noise_fn(self.step)
        else:
            dn["generator"] = torch.Generator().manual_seed(
                self.args["seed"] * 1000003 + self.step)
        return self.model(img, dn=dn)
