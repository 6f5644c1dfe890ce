"""Where the training step's time goes on the GPU.

    python -m mgdt_yolo_tpu_torch.tools.profile_training [--batch 32] [--steps 8]
        [--device-augment]

Loads the flagship MGDT-n from `weights/mgdt_n_synth.npz`, unfused, in
`train()` mode, and takes micro-steps of the `Trainer` (the JAX defaults
with SGD: accumulate = round(64 / batch), bf16 autocast, float32
parameters) on one resident batch of labelled synthetic 640 px scenes:
unaugmented (`cfg.default.UNAUGMENTED`) by default, or, with
`--device-augment`, a raw batch that every micro-step augments on the card
first (mosaic, warp, K3's flip + HSV + normalise, at the JAX defaults).
Prints, with the card's name and power limit:

* the split of a micro-step into augment, forward, loss + assigner,
  backward and optimizer + EMA, by CUDA events recorded between the five,
  the mean over `--steps` micro-steps (a multiple of `accumulate`, so the
  optimizer's share is per micro-step), min over 3 windows; and the
  micro-step time and train images/s;
* a torch.profiler table of device time by kernel over `--steps`
  micro-steps (the 40 largest), the device's busy and idle share of that
  window, and the hand-written kernels' (K1 `deform_fwd`, K2 `deform_bwd`,
  K3 `fused_augment`) shares.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..cfg.default import UNAUGMENTED
from ..data.build import DataLoader, to_device
from ..data.synthetic import SyntheticDetectionDataset
from ..device import resolve_device
from ..engine.trainer import Trainer
from ..nn.tasks import DetectionModel
from ..utils.measure import device_us, gpu_name_and_power

ROOT = Path(__file__).resolve().parents[2]
PARTS = ("augment", "forward", "loss", "backward", "optimizer")


def _split_ms(trainer, batch, steps: int):
    """Mean device ms per micro-step of each part over `steps` micro-steps."""
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append(ev)

    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        events.append([start])
        trainer.train_step(batch, mark)
    torch.cuda.synchronize()
    sums = dict.fromkeys(PARTS, 0.0)
    for evs in events:
        for name, a, b in zip(PARTS, evs, evs[1:]):
            sums[name] += a.elapsed_time(b)
    return {k: v / steps for k, v in sums.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device-augment", action="store_true",
                    help="augment a raw batch on the card in every micro-step")
    args = ap.parse_args(argv)

    dev = resolve_device()
    model = DetectionModel.from_npz(ROOT / "weights" / "mgdt_n_synth.npz", device=dev)
    ds = SyntheticDetectionDataset(n=args.batch, imgsz=640, seed=0)
    loader = DataLoader(ds, args.batch, 640, device_augment=args.device_augment)
    overrides = {"optimizer": "SGD", "batch": args.batch, "val": False,
                 **({} if args.device_augment else UNAUGMENTED)}
    trainer = Trainer(model, loader, overrides=overrides)
    steps = max(args.steps // trainer.accumulate, 1) * trainer.accumulate
    batch = to_device(next(iter(loader)), dev)
    for _ in range(2 * trainer.accumulate):       # warm-up: cuDNN picks, allocator
        trainer.train_step(batch)
    windows = [_split_ms(trainer, batch, steps) for _ in range(3)]
    split = min(windows, key=lambda w: sum(w.values()))
    total = sum(split.values())
    lines = [f"gpu: {gpu_name_and_power()}",
             f"batch {args.batch} at 640 px, "
             f"{'device augment' if args.device_augment else 'unaugmented'}, "
             f"bf16 autocast, {trainer.optimizer.name}, "
             f"accumulate {trainer.accumulate}: micro-step {total:.3f} ms "
             f"({args.batch / total * 1e3:.2f} train images/s); "
             + ", ".join(f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in split.items())]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    kernels.sort(key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in kernels)
    share = {name: sum(device_us(e) for e in kernels if name in e.key)
             for name in ("deform_fwd", "deform_bwd", "fused_augment")}
    lines.append(f"profiled {steps} micro-steps: wall {wall_us / 1e3:.3f} ms, device busy "
                 f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}), idle share "
                 f"{1 - busy_us / wall_us:.1%}; " + ", ".join(
                     f"{k} {v / 1e3 / steps:.4f} ms per micro-step "
                     f"({v / max(busy_us, 1e-9):.1%} of device time)" for k, v in share.items()))
    lines.append(f"{'device ms/step':>15} {'share':>7} {'calls':>7}  kernel")
    for e in kernels[:40]:
        lines.append(f"{device_us(e) / 1e3 / steps:15.4f} "
                     f"{device_us(e) / busy_us:7.1%} {e.count // steps:7d}  {e.key[:110]}")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
