"""A/B on the card: V4, the DCNv2 forward that skips zero-weight corners and
dead taps at run time: its Hopper design (`deform_fwd_slot_skip`, the Hopper
K1 with the skips) in turns against its first design on the CUDA cores
(`deform_fwd_slot_skip_simt`) and the Hopper K1 (`deform_fwd`), and both
designs against the SIMT K1 (`deform_fwd_simt`).

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_slot_skip [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_slot_skip.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds both designs
against K1's windowed plain version at (2, 16, 24, 8 -> 6) in float32 and
bf16, the Hopper V4 bit for bit to the Hopper K1 and the first design to
the SIMT K1. `bench` (card only) makes the JAX script's data on the card:
batch 512, 80x80, C 32 -> 32, bf16; x ~ N(0, 1), mask sigmoid(N(0, 1)),
weight N(0, 0.1^2), offsets N(0, 0.1^2) ("small-off") and N(0, 0.7^2)
("big-off"); and, for each, prints the share of corners and taps V4 skips
beyond K1 (`deform_variants.skip_shares`, on the first 8 images), times the
Hopper V4 in turns against its first design and the Hopper K1
(`deform_ab.ab_hopper`, which also holds it to the Hopper K1's bits), and
both designs against the SIMT K1 (`deform_ab.ab`: the first design must
give its bits), each held against K1's plain version on the first 8 images.
Then the Hopper V4 in turns against its first design and the Hopper K1 on
two inputs where its skips fire, to show what they save (checks of the
skips, not the JAX script's data; `deform_ab.skip_firing`): N(0, 0.7^2)
offsets rounded to {-2, ..., 2} (three corners in four of weight 0), and
those offsets unrounded with a mask that is 0 for a third of the (item,
tap) pairs, with the first case's x and weight.
"""
from __future__ import annotations

import sys

import torch

from ..ops import cuda_deform
from ..ops.cuda_deform_variants import deform_fwd_slot_skip, deform_fwd_slot_skip_simt
from ..ops.deform_variants import skip_shares, windowed_plain
from . import deform_ab

B, C, O = 512, 32, 32
NAME = "deform_fwd_slot_skip"


def check(device=None) -> dict:
    return {NAME: deform_ab.check(deform_fwd_slot_skip, windowed_plain, device,
                                  bitwise_to=cuda_deform.deform_fwd),
            f"{NAME}_simt": deform_ab.check(deform_fwd_slot_skip_simt, windowed_plain, device,
                                            bitwise_to=cuda_deform.deform_fwd_simt,
                                            bitwise_name="the SIMT K1")}


def bench() -> dict:
    k1_before = cuda_deform.launches  # the Hopper K1's, all as a baseline
    g = deform_ab.generator()
    shape = (B, deform_ab.H, deform_ab.W)
    x = deform_ab.normal(g, (*shape, C), 1.0)
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    mask = torch.sigmoid(deform_ab.normal(g, (*shape, 9), 1.0).to(torch.bfloat16))
    cases, hopper = [], []
    for label, std in (("small-off", 0.1), ("big-off", 0.7)):
        args = deform_ab.bf16(x, deform_ab.normal(g, (*shape, 18), std), mask, w)
        skips = skip_shares(args[1][:8], args[2][:8])
        print(f"{label}: V4 skips {skips['zero_corners']:.4%} of the corners K1 gathers and "
              f"{skips['dead_taps']:.4%} of the (item, tap) pairs (first 8 images)", flush=True)
        hopper.append({**deform_ab.ab_hopper(label, NAME, args), **skips})
        cases += [deform_ab.ab(label, name, fn, windowed_plain, args)
                  for name, fn in ((NAME, deform_fwd_slot_skip),
                                   (f"{NAME}_simt", deform_fwd_slot_skip_simt))]
        del args
    firing = []
    for label in ("integer offsets", "dead taps"):
        off, m = deform_ab.skip_firing(label, deform_ab.normal(g, (*shape, 18), 0.7), mask)
        args = deform_ab.bf16(x, off, m, w)
        skips = skip_shares(args[1][:8], args[2][:8])
        print(f"{label} (a check of the skips, not the JAX script's data): V4 skips "
              f"{skips['zero_corners']:.4%} of the corners K1 gathers and "
              f"{skips['dead_taps']:.4%} of the (item, tap) pairs (first 8 images)", flush=True)
        firing.append({**deform_ab.ab_hopper(label, NAME, args), **skips})
        del args
    return {"tool": "proto_deform_slot_skip", "cases": cases, "hopper": hopper,
            "skips_firing": firing,
            "hopper_k1_launches": cuda_deform.launches - k1_before}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
