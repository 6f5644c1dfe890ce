"""A/B on the card: V5, the DCNv2 forward contracted tap-outer: its Hopper
design (`deform_fwd_tapwalk`, one tap's weight slice resident and more
warps) in turns against its first design on the CUDA cores
(`deform_fwd_tapwalk_simt`) and the Hopper K1 (`deform_fwd`), and both
designs against the SIMT K1 (`deform_fwd_simt`), at C 64.

    python -m mgdt_yolo_tpu_torch.tools.proto_deform_tapwalk [check|bench] [--device cpu]

The port of the repo-root `tools/proto_deform_tapwalk.py` (a TPU A/B).
`check` (the default; on the card unless `--device cpu`) holds both designs
against K1's windowed plain version at (2, 16, 24, 8 -> 6) in float32 and
bf16, the Hopper V5 bit for bit to the Hopper K1 and the first design to
the SIMT K1. `bench` (card only) makes the JAX script's data on the card:
batch 512, 80x80, C 64 -> 64, bf16; x ~ N(0, 1), mask sigmoid(N(0, 1)),
weight N(0, 0.1^2), offsets N(0, 0.1^2) ("small-off") and N(0, 0.7^2)
clipped to +/-2 ("clamped +/-2"); prints each kernel's plan at C 64: the
SIMT K1's 230,400 B (one block of 8 warps per SM), the Hopper K1's (resident
or streamed, warps, bytes), V5's (warps, items per warp, bytes) and its
first design's; and, for each case, times the Hopper V5 in turns against
its first design and the Hopper K1 (`deform_ab.ab_hopper`, which also holds
it to the Hopper K1's bits), and both designs against the SIMT K1
(`deform_ab.ab`: the first design must give its bits), each held against
K1's plain version on the first 8 images (b8 at C 64). Last, on the first
case's data, V5 under other plans in turns with its own and the Hopper K1
(`plan_ab`): one item a warp, and the Hopper K1's warps with two items and
with one, each giving the Hopper K1's bits; this separates what the warps
buy from what the lockstep walk costs.
"""
from __future__ import annotations

import sys

import torch

from ..ops import cuda_deform, cuda_deform_variants
from ..ops.cuda_deform_variants import deform_fwd_tapwalk, deform_fwd_tapwalk_simt
from ..ops.deform_variants import windowed_plain
from ..utils.measure import cuda_time_ms
from . import deform_ab

B, C, O = 512, 64, 64
NAME = "deform_fwd_tapwalk"


def check(device=None) -> dict:
    return {NAME: deform_ab.check(deform_fwd_tapwalk, windowed_plain, device,
                                  bitwise_to=cuda_deform.deform_fwd),
            f"{NAME}_simt": deform_ab.check(deform_fwd_tapwalk_simt, windowed_plain, device,
                                            bitwise_to=cuda_deform.deform_fwd_simt,
                                            bitwise_name="the SIMT K1")}


def plans() -> dict:
    """Each kernel's plan at the bench's C 64 in bf16 on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1_smem = cuda_deform.simt_smem_bytes(C, O)
    simt_smem = cuda_deform_variants.smem_bytes(f"{NAME}_simt", deform_ab.W, C, O,
                                                torch.bfloat16)
    k1 = cuda_deform_variants.hopper_k1_plan(C, O, torch.bfloat16)
    v5 = cuda_deform_variants.tc_plan(NAME, B, deform_ab.H, deform_ab.W, C, O, torch.bfloat16,
                                      sms)
    out = {"simt_k1_smem_bytes": k1_smem, "simt_k1_blocks_per_sm": deform_ab.occupancy(k1_smem),
           "hopper_k1_plan": k1["plan"], "hopper_k1_warps": k1["warps"],
           "hopper_k1_smem_bytes": k1["smem"], "warps": v5["warps"],
           "items_per_warp": v5["items_per_warp"], "smem_bytes": v5["smem"],
           "blocks": v5["blocks"], "simt_smem_bytes": simt_smem,
           "simt_blocks_per_sm": deform_ab.occupancy(simt_smem)}
    print(f"shared memory per block at C {C} bf16: the SIMT K1 {k1_smem} B "
          f"({out['simt_k1_blocks_per_sm']} block(s) of 8 warps per SM); the Hopper K1 "
          f"{k1['plan']}, {k1['warps']} warps, {k1['smem']} B; the Hopper V5 {v5['warps']} "
          f"warps x {v5['items_per_warp']} items, {v5['smem']} B, {v5['blocks']} blocks; its "
          f"first design {simt_smem} B ({out['simt_blocks_per_sm']} blocks of 8 warps per SM)",
          flush=True)
    return out


def plan_ab(args, k1_warps, iters=3, windows=3) -> list:
    """The Hopper V5 on `args` (bf16) under its own plan and under (its
    warps, one item a warp), (`k1_warps`, two items), (`k1_warps`, one
    item), in turns with the Hopper K1: forward through the plans and K1,
    then back (min over windows of each, CUDA events). Each plan's output
    must give the Hopper K1's bits (RuntimeError otherwise). Prints one line
    per plan and returns the rows."""
    x, _, _, w = args
    Bx, Hx, Wx, Cx = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    own = cuda_deform_variants.tc_plan(NAME, Bx, Hx, Wx, Cx, w.shape[3], x.dtype, sms)
    wanted = [(own["warps"], own["items_per_warp"]), (own["warps"], 1), (k1_warps, 2),
              (k1_warps, 1)]
    plans = {}
    for warps, ipw in dict.fromkeys(wanted):
        plans[(warps, ipw)] = cuda_deform_variants.tc_plan(NAME, Bx, Hx, Wx, Cx, w.shape[3],
                                                           x.dtype, sms, warps, ipw)
    k1 = cuda_deform.deform_fwd(*args)
    for key, plan in plans.items():
        if not torch.equal(deform_fwd_tapwalk(*args, plan=plan), k1):
            raise RuntimeError(f"V5 under the plan {key} differs from the Hopper K1")
    del k1
    fns = {**{key: (lambda plan=plan: deform_fwd_tapwalk(*args, plan=plan))
              for key, plan in plans.items()},
           "k1": lambda: cuda_deform.deform_fwd(*args)}
    order = list(fns)
    times = {key: [] for key in fns}
    for key in order + order[::-1]:
        times[key].append(cuda_time_ms(fns[key], iters=iters, windows=windows))
    k1_ms = min(times["k1"])
    rows = []
    for (warps, ipw), plan in plans.items():
        ms = min(times[(warps, ipw)])
        rows.append({"warps": warps, "items_per_warp": ipw, "smem": plan["smem"],
                     "blocks": plan["blocks"], "ms": ms, "hopper_k1_ms": k1_ms,
                     "k1_over_variant": k1_ms / ms, "chosen": plan["smem"] == own["smem"] and
                     (warps, ipw) == (own["warps"], own["items_per_warp"])})
        print(f"plan A/B ({Bx},{Hx},{Wx},{Cx}->{w.shape[3]}) bf16: V5 {warps} warps x {ipw} "
              f"items ({plan['smem']} B) " + " / ".join(f"{t:.4f}" for t in times[(warps, ipw)]) +
              f" ms, the Hopper K1 " + " / ".join(f"{t:.4f}" for t in times["k1"]) +
              f" ms (K1 / V5 {k1_ms / ms:.3f}){' (chosen)' if rows[-1]['chosen'] else ''}",
              flush=True)
    return rows


def bench() -> dict:
    k1_before = cuda_deform.launches  # the Hopper K1's, all as a baseline
    g = deform_ab.generator()
    shape = (B, deform_ab.H, deform_ab.W)
    x = deform_ab.normal(g, (*shape, C), 1.0)
    w = deform_ab.normal(g, (3, 3, C, O), 0.1)
    mask = torch.sigmoid(deform_ab.normal(g, (*shape, 9), 1.0).to(torch.bfloat16))
    occ = plans()
    cases, hopper, plan_rows = [], [], []
    for label, std, clip in (("small-off", 0.1, None), ("clamped +/-2", 0.7, 2.0)):
        off = deform_ab.normal(g, (*shape, 18), std)
        if clip is not None:
            off = off.clamp(-clip, clip)
        args = deform_ab.bf16(x, off, mask, w)
        hopper.append({**deform_ab.ab_hopper(label, NAME, args, iters=3), **occ})
        cases += [{**deform_ab.ab(label, name, fn, windowed_plain, args, iters=3), **occ}
                  for name, fn in ((NAME, deform_fwd_tapwalk),
                                   (f"{NAME}_simt", deform_fwd_tapwalk_simt))]
        if not plan_rows:
            plan_rows = plan_ab(args, occ["hopper_k1_warps"])
        del args
    return {"tool": "proto_deform_tapwalk", "cases": cases, "hopper": hopper,
            "plans": plan_rows,
            "hopper_k1_launches": cuda_deform.launches - k1_before}


def main(argv=None) -> int:
    return deform_ab.main(argv, __doc__, check, bench)


if __name__ == "__main__":
    sys.exit(main())
