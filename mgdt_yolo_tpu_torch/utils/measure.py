"""Timing on the GPU, the card's bounds and float32 without TF32, shared by
`chip_smoke.py` and the tools."""
from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12                             # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type


def deform_fwd_bound_ms(B, H, W, C, O, dtype_name):
    """The DCNv2 forward's least time on the card, in ms, and what bounds it:
    each input read once and the output written once, against the
    contraction plus the bilinear sampling operations."""
    esize = 2 if dtype_name == "bfloat16" else 4
    P = H * W
    nbytes = (B * P * (C + 18 + 9 + O) + 9 * C * O) * esize
    flops = 2 * B * P * 9 * C * O + 8 * B * P * 9 * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def deform_bwd_bound_ms(B, H, W, C, O, dtype_name):
    """The DCNv2 backward's least time on the card, in ms, and what bounds
    it: x, offset, mask, weight and the output gradient read once, d x,
    d offset, d mask and d weight written once, against the two
    contractions with the weight (tap gradient, weight gradient) plus the
    sampling work per (pixel, tap, channel, corner): the recomputed sample,
    the corner-weight gradient and the scatter into d x, 2 operations each."""
    esize = 2 if dtype_name == "bfloat16" else 4
    P = H * W
    nbytes = (B * P * ((C + 18 + 9 + O) + (C + 18 + 9)) + 2 * 9 * C * O) * esize
    flops = 2 * (2 * B * P * 9 * C * O) + 4 * 6 * B * P * 9 * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class float32_exact:
    """TF32 off for cuDNN convolutions and matrix products inside the block,
    so float32 on the card is compared as float32."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


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
