"""A/B on the card: V1, the DCNv2 forward with bf16 corner weights and bf16
corner products (`deform_fwd_bf16_fma`), against the SIMT K1
(`deform_fwd_simt`).

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_bf16_fma [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_bf16_fma.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds V1 against
its plain version `deform_bf16_fma_plain` at (2, 16, 24, 8 -> 6) in float32
and bf16. `bench` (card only) makes the JAX script's data on the card: batch
512, 80x80, C 32 -> 32, bf16; x ~ N(0, 1), offsets N(0, 0.7^2), mask
sigmoid(N(0, 1)), weight N(0, 0.1^2); holds V1 and K1 against their plain
versions on the first 8 images; and prints K1's time, V1's, their ratio and
V1's largest absolute and relative difference from K1.
"""
from __future__ import annotations

import sys

import torch

from ..ops.cuda_deform_variants import deform_fwd_bf16_fma
from ..ops.deform_variants import deform_bf16_fma_plain
from . import deform_ab

B, C, O = 512, 32, 32


def check(device=None) -> dict:
    return deform_ab.check(deform_fwd_bf16_fma, deform_bf16_fma_plain, device)


def bench() -> dict:
    g = deform_ab.generator()
    x = deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, C), 1.0)
    off = deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, 18), 0.7)
    mask = torch.sigmoid(deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, 9), 1.0)
                         .to(torch.bfloat16))
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    args = deform_ab.bf16(x, off, mask, w)
    return {"tool": "proto_deform_bf16_fma",
            "cases": [deform_ab.ab("bf16 slot FMA", "deform_fwd_bf16_fma",
                                   deform_fwd_bf16_fma, deform_bf16_fma_plain, args)]}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
