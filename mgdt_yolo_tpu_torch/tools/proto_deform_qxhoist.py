"""A/B on the card: V2, the DCNv2 forward from an input slab staged once per
block in shared memory (`deform_qxhoist`), and V3, the same slab converted
to float32 once (`deform_cvt1`), against the SIMT K1
(`deform_fwd_simt`).

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_qxhoist [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_qxhoist.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds both against
K1's windowed plain version at (2, 16, 24, 8 -> 6) in float32 and bf16,
without and with a bias. `bench` (card only) makes the JAX script's data on
the card: batch 128, 80x80, C 32 -> 32, bf16; x ~ N(0, 1), offsets
U(-3, 3), mask U(0, 1), weight N(0, 0.1^2); holds each variant and K1
against K1's plain version on the first 8 images; and prints K1's time, each
variant's, their ratio and each variant's largest difference from K1.
"""
from __future__ import annotations

import sys

from ..ops.cuda_deform_variants import deform_cvt1, deform_qxhoist
from ..ops.deform_variants import windowed_plain
from . import deform_ab

B, C, O = 128, 32, 32


def check(device=None) -> dict:
    return {name: deform_ab.check(fn, windowed_plain, device, bias_cases=(False, True))
            for name, fn in (("deform_qxhoist", deform_qxhoist), ("deform_cvt1", deform_cvt1))}


def bench() -> dict:
    g = deform_ab.generator()
    x = deform_ab.normal(g, (B, deform_ab.H, deform_ab.W, C), 1.0)
    off = deform_ab.uniform(g, (B, deform_ab.H, deform_ab.W, 18), -3.0, 3.0)
    mask = deform_ab.uniform(g, (B, deform_ab.H, deform_ab.W, 9), 0.0, 1.0)
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    args = deform_ab.bf16(x, off, mask, w)
    return {"tool": "proto_deform_qxhoist",
            "cases": [deform_ab.ab("qxhoist", "deform_fwd_qxhoist", deform_qxhoist,
                                   windowed_plain, args, iters=20),
                      deform_ab.ab("cvt1", "deform_fwd_cvt1", deform_cvt1, windowed_plain,
                                   args, iters=20)]}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
