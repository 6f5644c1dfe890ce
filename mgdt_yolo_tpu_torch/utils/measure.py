"""Timing on the GPU, shared by `chip_smoke.py` and the profiling tool."""
from __future__ import annotations

import subprocess

import torch


def gpu_name_and_power() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, windows: int = 5) -> float:
    """Min over `windows` of the mean time of `iters` back-to-back calls of
    `fn`, by CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_us(event) -> float:
    """Device time of a `torch.profiler` key-average entry, in microseconds
    (the attribute's name differs between PyTorch versions)."""
    v = getattr(event, "self_device_time_total", None)
    return float(v if v is not None else event.self_cuda_time_total)
