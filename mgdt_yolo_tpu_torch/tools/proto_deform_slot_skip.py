"""A/B on the card: V4, the DCNv2 forward that skips zero-weight corners and
dead (pixel, tap) pairs at run time (`deform_fwd_slot_skip`), against K1
(`deform_fwd`).

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_slot_skip [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_slot_skip.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds V4 against
K1's windowed plain version at (2, 16, 24, 8 -> 6) in float32 and bf16.
`bench` (card only) makes the JAX script's data on the card: batch 512,
80x80, C 32 -> 32, bf16; x ~ N(0, 1), mask sigmoid(N(0, 1)), weight
N(0, 0.1^2), offsets N(0, 0.1^2) ("small-off") and N(0, 0.7^2)
("big-off"); and, for each, holds V4 and K1 against K1's plain version on
the first 8 images and prints K1's time, V4's, their ratio and V4's largest
difference from K1 (0: V4 keeps K1's bits).
"""
from __future__ import annotations

import sys

import torch

from ..ops.cuda_deform_variants import deform_fwd_slot_skip
from ..ops.deform_variants import windowed_plain
from . import deform_ab

B, C, O = 512, 32, 32


def check(device=None) -> dict:
    return deform_ab.check(deform_fwd_slot_skip, windowed_plain, device)


def bench() -> dict:
    g = deform_ab.generator()
    shape = (B, deform_ab.H, deform_ab.W)
    x = deform_ab.normal(g, (*shape, C), 1.0)
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    mask = torch.sigmoid(deform_ab.normal(g, (*shape, 9), 1.0).to(torch.bfloat16))
    cases = []
    for label, std in (("small-off", 0.1), ("big-off", 0.7)):
        args = deform_ab.bf16(x, deform_ab.normal(g, (*shape, 18), std), mask, w)
        cases.append(deform_ab.ab(label, "deform_fwd_slot_skip", deform_fwd_slot_skip,
                                  windowed_plain, args))
        del args
    return {"tool": "proto_deform_slot_skip", "cases": cases}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
