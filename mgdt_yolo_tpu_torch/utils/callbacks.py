"""The lifecycle callback bus, a copy of the JAX package's
`mgdt_yolo_tpu/utils/callbacks.py`: the same 25 hooks, so a user's
callbacks work with either package, and `CallbackMixin`, which the
`Trainer`, `DetectionValidator`, `BasePredictor` and `Exporter` take.
A callback is a function of the engine that fires it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

HOOKS = [
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
    "on_train_epoch_start", "on_train_batch_start", "optimizer_step",
    "on_before_zero_grad", "on_train_batch_end", "on_train_epoch_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end", "on_params_update",
    "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    # exporter
    "on_export_start", "on_export_end",
]


def get_default_callbacks() -> Dict[str, List[Callable]]:
    return defaultdict(list, {h: [] for h in HOOKS})


class CallbackMixin:
    """`add_callback(event, func)` and `run_callbacks(event)` for an engine."""

    def init_callbacks(self):
        self.callbacks = get_default_callbacks()

    def add_callback(self, event: str, func: Callable):
        self.callbacks[event].append(func)

    def run_callbacks(self, event: str):
        for f in self.callbacks.get(event, []):
            f(self)
