"""A/B on the card: V5, the DCNv2 forward contracted tap by tap
(`deform_fwd_tapwalk`), against K1 (`deform_fwd`), at C 64.

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_tapwalk [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_tapwalk.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds V5 against
K1's windowed plain version at (2, 16, 24, 8 -> 6) in float32 and bf16.
`bench` (card only) makes the JAX script's data on the card: batch 512,
80x80, C 64 -> 64, bf16; x ~ N(0, 1), mask sigmoid(N(0, 1)), weight
N(0, 0.1^2), offsets N(0, 0.1^2) ("small-off") and N(0, 0.7^2) clipped to
+/-2 ("clamped +/-2"); and, for each, holds V5 and K1 against K1's plain
version on the first 8 images (b8 at C 64) and prints K1's time, V5's, their
ratio and V5's largest difference from K1, with each kernel's shared memory
per block and the blocks that fit on an SM by it: at C 64, K1 needs
230,400 B and fits one.
"""
from __future__ import annotations

import sys

import torch

from ..ops import cuda_deform, cuda_deform_variants
from ..ops.cuda_deform_variants import deform_fwd_tapwalk
from ..ops.deform_variants import windowed_plain
from . import deform_ab

B, C, O = 512, 64, 64


def check(device=None) -> dict:
    return deform_ab.check(deform_fwd_tapwalk, windowed_plain, device)


def bench() -> dict:
    g = deform_ab.generator()
    shape = (B, deform_ab.H, deform_ab.W)
    x = deform_ab.normal(g, (*shape, C), 1.0)
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    mask = torch.sigmoid(deform_ab.normal(g, (*shape, 9), 1.0).to(torch.bfloat16))
    k1_smem = cuda_deform.smem_bytes(C, O)
    v5_smem = cuda_deform_variants.smem_bytes("deform_fwd_tapwalk", deform_ab.W, C, O,
                                              torch.bfloat16)
    occ = {"k1_smem_bytes": k1_smem, "k1_blocks_per_sm": deform_ab.occupancy(k1_smem),
           "smem_bytes": v5_smem, "blocks_per_sm": deform_ab.occupancy(v5_smem)}
    print(f"shared memory per block at C {C}: K1 {k1_smem} B ({occ['k1_blocks_per_sm']} "
          f"block(s) of 8 warps per SM), V5 {v5_smem} B ({occ['blocks_per_sm']} per SM), "
          "by shared memory and threads", flush=True)
    cases = []
    for label, std, clip in (("small-off", 0.1, None), ("clamped +/-2", 0.7, 2.0)):
        off = deform_ab.normal(g, (*shape, 18), std)
        if clip is not None:
            off = off.clamp(-clip, clip)
        args = deform_ab.bf16(x, off, mask, w)
        cases.append({**deform_ab.ab(label, "deform_fwd_tapwalk", deform_fwd_tapwalk,
                                     windowed_plain, args, iters=3), **occ})
        del args
    return {"tool": "proto_deform_tapwalk", "cases": cases}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
