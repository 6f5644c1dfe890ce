"""Hyperparameter search: the counterpart of `mgdt_yolo_tpu/utils/tuner.py`.

`run_tune` is the JAX package's seeded random search: trial `t` draws every
key of the space uniformly from one `random.Random(seed)`, in the space's
key order, so its hyperparameters are the JAX search's bit for bit, and
trains the model in place under the run name `tune_<t>`. `run_ray_tune`
takes that search where ray does not import, as JAX's does.

JAX's default space draws `degrees`, `shear`, `perspective`, `mixup` and
`copy_paste` above 0 in every trial; the trainer takes them through the host
augmentation pipeline, as JAX's does, so every trial trains. Every drawn
configuration is held to the trainer's rules (`check_train_args`) before the
first trial. One place where the port parts from JAX on purpose: an
exception inside a trial ends the search (JAX scores the trial -1 and goes
on), so a failing kernel launch cannot hide behind a finished tune.
"""
from __future__ import annotations

import logging
import random
from typing import Dict, Optional

from ..engine.trainer import check_train_args

LOGGER = logging.getLogger(__name__)

# the JAX package's space (the reference's default_space), all uniform
SEARCH_SPACE = {
    "lr0": (1e-5, 1e-1),
    "lrf": (0.01, 1.0),
    "momentum": (0.6, 0.98),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "warmup_momentum": (0.0, 0.95),
    "box": (0.02, 0.2),
    "cls": (0.2, 4.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "degrees": (0.0, 45.0),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.9),
    "shear": (0.0, 10.0),
    "perspective": (0.0, 0.001),
    "flipud": (0.0, 1.0),
    "fliplr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
    "mixup": (0.0, 1.0),
    "copy_paste": (0.0, 1.0),
}


def _sample(rng: random.Random, space: Optional[Dict] = None) -> Dict[str, float]:
    """One configuration: each key of the space uniform in its bounds."""
    return {k: rng.uniform(b[0], b[1]) for k, b in (space or SEARCH_SPACE).items()}


def check_trials(configs, base: Dict) -> None:
    """Raise before any training where a trial's keys would be refused by
    `check_train_args`."""
    for cfg in configs:
        check_train_args({**cfg, **base})


def run_tune(model, data: str = "synthetic", n_trials: int = 10, epochs_per_trial: int = 10,
             seed: int = 0, space: Optional[Dict] = None, **train_kwargs):
    """The random search: (best configuration, best fitness, history).
    `train_kwargs` (the user's train arguments) win over `data` and
    `epochs_per_trial`; `name` is the loop's own. `model` is a `YOLO`
    facade (anything with `train(**overrides) -> metrics`)."""
    rng = random.Random(seed)
    base = {"data": data, "epochs": epochs_per_trial}
    base.update(train_kwargs)
    base.pop("name", None)
    configs = [_sample(rng, space) for _ in range(n_trials)]
    check_trials(configs, base)
    best_cfg, best_fit, history = None, -1.0, []
    for t, cfg in enumerate(configs):
        head = ", ".join(f"{k}={v:.3g}" for k, v in list(cfg.items())[:3])
        LOGGER.info(f"tune trial {t + 1}/{n_trials}: {head} ...")
        metrics = model.train(name=f"tune_{t}", **cfg, **base)
        fit = float(metrics.get("fitness", metrics.get("top1", 0.0)))
        history.append({"trial": t, "fitness": fit, **cfg})
        if fit > best_fit:
            best_fit, best_cfg = fit, cfg
    LOGGER.info(f"tune done: best fitness {best_fit:.4f}")
    return best_cfg, best_fit, history


def run_ray_tune(model, data: str = "synthetic", space: Optional[Dict] = None,
                 grace_period: int = 10, max_samples: int = 10,
                 train_args: Optional[Dict] = None, **kwargs):
    """The built-in search (`run_tune`, `max_samples` trials, the user's
    `train_args` merged) where ray does not import, as JAX's falls back; the
    Ray Tune ASHA branch itself is not ported (ROADMAP queue 1, item 13)."""
    try:
        import ray  # noqa: F401
    except ImportError:
        LOGGER.info("ray not installed; using built-in random search")
        ta = dict(train_args or {})
        ta.setdefault("data", data)
        return run_tune(model, n_trials=max_samples, space=space, **ta, **kwargs)
    raise NotImplementedError("ray imports here, and the port's Ray Tune ASHA search is not "
                              "ported (ROADMAP queue 1, item 13): the built-in search runs "
                              "where ray does not import")
