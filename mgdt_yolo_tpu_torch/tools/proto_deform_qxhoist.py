"""A/B on the card: V2, the DCNv2 forward with its corner rows read from a
ring of input rows in shared memory (`deform_qxhoist`), and V3, the same
ring in float32, each row converted once (`deform_cvt1`): their Hopper
designs against their first designs on the CUDA cores
(`deform_qxhoist_simt`, `deform_cvt1_simt`), the Hopper K1
(`deform_fwd`) and the SIMT K1 (`deform_fwd_simt`).

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_qxhoist [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_qxhoist.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds all four
against K1's windowed plain version at (2, 16, 24, 8 -> 6) in float32 and
bf16, without and with a bias, and the Hopper designs bit for bit to the
Hopper K1. `bench` (card only) makes the JAX script's data on the card:
batch 128, 80x80, C 32 -> 32, bf16; x ~ N(0, 1), offsets U(-3, 3), mask
U(0, 1), weight N(0, 0.1^2); times each Hopper design in turns against its
first design and the Hopper K1 (`deform_ab.ab_hopper`, which also holds it to
the Hopper K1's bits), and all four against the SIMT K1 (`deform_ab.ab`),
each held against K1's plain version on the first 8 images.
"""
from __future__ import annotations

import sys

from ..ops import cuda_deform
from ..ops.cuda_deform_variants import FIRST_DESIGNS, SLAB_KERNELS, VARIANTS
from ..ops.deform_variants import windowed_plain
from . import deform_ab

B, C, O = 128, 32, 32


def check(device=None) -> dict:
    out = {}
    for name in SLAB_KERNELS:
        out[name] = deform_ab.check(VARIANTS[name][0], windowed_plain, device,
                                    bias_cases=(False, True), bitwise_to=cuda_deform.deform_fwd)
    for name in SLAB_KERNELS:
        simt_name, fn, _ = FIRST_DESIGNS[name]
        out[simt_name] = deform_ab.check(fn, windowed_plain, device, bias_cases=(False, True))
    return out


def bench() -> dict:
    k1_before = cuda_deform.launches  # the Hopper K1's, all as a baseline
    g = deform_ab.generator()
    x = deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, C), 1.0)
    off = deform_ab.uniform(g, (B, deform_ab.H, deform_ab.W, 18), -3.0, 3.0)
    mask = deform_ab.uniform(g, (B, deform_ab.H, deform_ab.W, 9), 0.0, 1.0)
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    args = deform_ab.bf16(x, off, mask, w)
    slab = [deform_ab.ab_hopper(f"{name[11:]} b{B}", name, args, iters=20)
            for name in SLAB_KERNELS]
    cases = [deform_ab.ab(name[11:], name, fn, windowed_plain, args, iters=20)
             for name, fn in [*((n, VARIANTS[n][0]) for n in SLAB_KERNELS),
                              *(FIRST_DESIGNS[n][:2] for n in SLAB_KERNELS)]]
    return {"tool": "proto_deform_qxhoist", "cases": cases, "hopper": slab,
            "hopper_k1_launches": cuda_deform.launches - k1_before}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
