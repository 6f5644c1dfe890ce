"""The port's tuner (`utils/tuner.py`, `YOLO.tune`) against the JAX
package's (`mgdt_yolo_tpu/utils/tuner.py`), on the CPU.

* the draws: equal, float for float (one `random.Random(seed)` over the
  space in its key order on both sides);
* a search over a stub model whose fitness is scripted: the same trials,
  run names, train arguments, history and best configuration;
* JAX's default space, whose `degrees`, `shear`, `perspective`, `mixup`
  and `copy_paste` the trainer takes through the host pipeline: every trial
  trains, with JAX's keywords;
* the place the port parts from JAX on purpose (ROADMAP queue 3): an
  exception inside a trial ends the search (JAX scores it -1 and goes on);
* the facade's `tune` over a space of keys the port honours, two trials
  of one epoch on a small dataset, each in its own run directory.
"""
import random

import pytest

from mgdt_yolo_tpu.utils import tuner as jax_tuner
from mgdt_yolo_tpu_torch.engine.model import YOLO
from mgdt_yolo_tpu_torch.utils import tuner
from test_torch_facade import one_torch_thread  # noqa: F401  (autouse)
from test_torch_facade import TRAIN_ARGS, write_counting_dir
from test_torch_predict import NPZ

# keys the device augmentation and the trainer honour
HONOURED_SPACE = {"lr0": (1e-4, 1e-2), "momentum": (0.6, 0.98), "weight_decay": (0.0, 0.001),
                  "box": (0.02, 0.2), "cls": (0.2, 4.0), "hsv_h": (0.0, 0.1),
                  "hsv_s": (0.0, 0.9), "translate": (0.0, 0.9), "scale": (0.0, 0.9),
                  "fliplr": (0.0, 1.0), "mosaic": (0.0, 1.0)}
# keys only the host augmentation pipeline honours
HOST_ONLY = ("degrees", "shear", "perspective", "mixup", "copy_paste")


class StubModel:
    """A facade stand-in: `train` records its keywords and returns the next
    scripted fitness; `fail_at` raises in that trial."""

    def __init__(self, fitness, fail_at=None):
        self.fitness, self.fail_at, self.calls = list(fitness), fail_at, []

    def train(self, **kw):
        self.calls.append(kw)
        if len(self.calls) - 1 == self.fail_at:
            raise RuntimeError("a kernel launch failed")
        return {"fitness": self.fitness[len(self.calls) - 1]}


@pytest.mark.parametrize("seed", [0, 17])
def test_draws_match_jax(seed):
    ours, theirs = random.Random(seed), random.Random(seed)
    for space in (None, HONOURED_SPACE):
        for _ in range(5):
            a, b = tuner._sample(ours, space), jax_tuner._sample(theirs, space)
            assert a == b and list(a) == list(space or jax_tuner.SEARCH_SPACE)
    assert tuner.SEARCH_SPACE == jax_tuner.SEARCH_SPACE


@pytest.mark.parametrize("seed", [0, 3])
def test_search_over_a_stub_matches_jax(seed):
    """History, best configuration and best fitness equal JAX's, each
    trial trained with JAX's keywords (`tune_<t>`, the draws, data and
    epochs, the user's train arguments)."""
    fitness = [0.2, 0.5, 0.1, 0.5, 0.4]
    ours, theirs = StubModel(fitness), StubModel(fitness)
    kw = dict(data="synthetic", n_trials=5, epochs_per_trial=2, seed=seed,
              space=HONOURED_SPACE, imgsz=64, name="ignored")
    got, want = tuner.run_tune(ours, **kw), jax_tuner.run_tune(theirs, **kw)
    assert got == want
    assert ours.calls == theirs.calls and [c["name"] for c in ours.calls] == \
        [f"tune_{t}" for t in range(5)]
    first_best = got[2][1]  # the first trial at the best fitness wins
    assert got[1] == first_best["fitness"] == 0.5
    assert got[0] == {k: v for k, v in first_best.items() if k not in ("trial", "fitness")}


def test_ray_fallback_matches_jax():
    """Without ray, `run_ray_tune` is the built-in search over `max_samples`
    trials with the user's `train_args` merged, as JAX's."""
    ours, theirs = StubModel([0.3, 0.1, 0.6]), StubModel([0.3, 0.1, 0.6])
    kw = dict(data="synthetic", space=HONOURED_SPACE, max_samples=3,
              train_args={"epochs": 1, "imgsz": 64})
    assert tuner.run_ray_tune(ours, **kw) == jax_tuner.run_ray_tune(theirs, **kw)
    assert ours.calls == theirs.calls and ours.calls[0]["epochs"] == 1


def test_default_space_raises_naming_its_five_keys():
    """Every trial of JAX's default space draws the five keys above 0; the
    port trains each trial with them, as JAX does (the same calls, history
    and best), each routed to the host pipeline, and a space holding one of
    them trains too."""
    from mgdt_yolo_tpu_torch.engine.trainer import check_augment_args, check_train_args
    ours, theirs = StubModel([0.1, 0.6, 0.3]), StubModel([0.1, 0.6, 0.3])
    got, want = tuner.run_tune(ours, n_trials=3), jax_tuner.run_tune(theirs, n_trials=3)
    assert got == want and got[1] == 0.6
    assert ours.calls == theirs.calls and len(ours.calls) == 3
    for kw in ours.calls:
        assert all(kw[k] > 0 for k in HOST_ONLY)
        args = check_train_args({k: v for k, v in kw.items() if k != "name"})
        assert check_augment_args(args) is False
        assert check_augment_args({**args, "device_augment": True}) is False
    mixed = StubModel([0.7])
    assert tuner.run_tune(mixed, n_trials=1, space={**HONOURED_SPACE, "mixup": (0.0, 1.0)}
                          )[1] == 0.7
    assert mixed.calls[0]["mixup"] > 0
    assert tuner.run_tune(StubModel([0.7]), n_trials=1, space=HONOURED_SPACE)[1] == 0.7


def test_an_exception_in_a_trial_ends_the_search():
    """The port raises where JAX scores the trial -1 and goes on."""
    ours = StubModel([0.2, 0.9, 0.4], fail_at=1)
    with pytest.raises(RuntimeError, match="kernel launch"):
        tuner.run_tune(ours, n_trials=3, space=HONOURED_SPACE)
    assert len(ours.calls) == 2
    theirs = StubModel([0.2, 0.9, 0.4], fail_at=1)
    _, fit, history = jax_tuner.run_tune(theirs, n_trials=3, space=HONOURED_SPACE)
    assert [h["fitness"] for h in history] == [0.2, -1.0, 0.4] and fit == 0.4


def test_facade_tune_runs_each_trial_in_its_own_directory(tmp_path):
    """`YOLO.tune` over the honoured keys: two trials of one epoch, each in
    `project/tune_<t>`, the history holding each trial's fitness."""
    data = write_counting_dir(tmp_path / "data")
    y = YOLO(NPZ, device="cpu")
    best, fit, history = y.tune(data=str(data), space=HONOURED_SPACE, max_samples=2,
                                train_args={**TRAIN_ARGS, "project": str(tmp_path / "runs")})
    assert [h["trial"] for h in history] == [0, 1] and best is not None
    assert all(h["fitness"] >= 0 for h in history) and fit == max(h["fitness"] for h in history)
    for t in range(2):
        assert (tmp_path / "runs" / f"tune_{t}" / "results.csv").is_file()
