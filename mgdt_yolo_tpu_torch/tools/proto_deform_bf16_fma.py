"""A/B on the card: V1, the DCNv2 forward with bf16 corner weights and bf16
corner products: its Hopper design (`deform_fwd_bf16_fma`, the corner
products fed to the tensor cores as they are) in turns against its first
design on the CUDA cores (`deform_fwd_bf16_fma_simt`) and the Hopper K1
(`deform_fwd`), and both designs against the SIMT K1 (`deform_fwd_simt`).

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_bf16_fma [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_bf16_fma.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds both designs
against their plain version `deform_bf16_fma_plain` at (2, 16, 24, 8 -> 6)
in float32 and bf16, with the SIMT K1's output as the control that must fail
V1's limits. `bench` (card only) makes the JAX script's data on the card:
batch 512, 80x80, C 32 -> 32, bf16; x ~ N(0, 1), offsets N(0, 0.7^2), mask
sigmoid(N(0, 1)), weight N(0, 0.1^2); times the Hopper V1 in turns against
its first design and the Hopper K1 (`deform_ab.ab_hopper`: V1 within its
limits of its first design on the whole batch and of its plain version on
the first 8 images, with the Hopper K1's output failing V1's limits and V1's
failing K1's), then both designs against the SIMT K1 (`deform_ab.ab`), each
held against its plain version on the first 8 images, and prints each
time, ratio and V1's largest absolute and relative difference from K1.
"""
from __future__ import annotations

import sys

import torch

from ..ops import cuda_deform
from ..ops.cuda_deform_variants import deform_fwd_bf16_fma, deform_fwd_bf16_fma_simt
from ..ops.deform_variants import deform_bf16_fma_plain
from . import deform_ab

B, C, O = 512, 32, 32
NAME = "deform_fwd_bf16_fma"


def check(device=None) -> dict:
    return {NAME: deform_ab.check(deform_fwd_bf16_fma, deform_bf16_fma_plain, device),
            f"{NAME}_simt": deform_ab.check(deform_fwd_bf16_fma_simt, deform_bf16_fma_plain,
                                            device)}


def bench() -> dict:
    k1_before = cuda_deform.launches  # the Hopper K1's, all as a baseline
    g = deform_ab.generator()
    x = deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, C), 1.0)
    off = deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, 18), 0.7)
    mask = torch.sigmoid(deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, 9), 1.0)
                         .to(torch.bfloat16))
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    args = deform_ab.bf16(x, off, mask, w)
    hopper = [deform_ab.ab_hopper("bf16 slot FMA", NAME, args)]
    cases = [deform_ab.ab("bf16 slot FMA", name, fn, deform_bf16_fma_plain, args)
             for name, fn in ((NAME, deform_fwd_bf16_fma),
                              (f"{NAME}_simt", deform_fwd_bf16_fma_simt))]
    return {"tool": "proto_deform_bf16_fma", "cases": cases, "hopper": hopper,
            "hopper_k1_launches": cuda_deform.launches - k1_before}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
