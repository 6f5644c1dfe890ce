"""Shared by the K1-variant A/B tools (`proto_deform_*.py` beside this file):
the check of a variant against its plain version, the inputs of the A/B runs
and the timing of a variant against K1 on the card, with both held against
their plain versions on the A/B's own inputs.

"K1" here is the SIMT K1, `cuda_deform.deform_fwd_simt`: V1 and the first
designs of V2-V5 are redesigns of its CUDA-core arithmetic, and those of V4
and V5 keep its float32 order, so it is their baseline and their bitwise
reference; every variant is timed against it (`ab`), so the series of
earlier runs goes on. The Hopper V2-V5 are K1's tensor-core design
(`cuda_deform.deform_fwd`, "the Hopper K1") with each variant's idea:
`ab_hopper` times each in turns against its first design
(`cuda_deform_variants.FIRST_DESIGNS`) and against the Hopper K1, whose bits
it must give. The model's K1 is A/B'd against the SIMT K1 by
`chip_smoke.py` phase 3.

Each tool ports one A/B script of the repo-root `tools/` (JAX on a TPU) and
keeps that script's shapes and data distributions; the data is made anew
from a seeded `torch.Generator`, so its values are the port's own.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..ops import cuda_deform
from ..ops.cuda_deform_variants import FIRST_DESIGNS, VARIANTS
from ..ops.deform_variants import compare, windowed_plain
from ..utils.measure import (cuda_time_ms, deform_fwd_bound_ms, float32_exact,
                             gpu_name_and_power)

H = W = 80                          # the flagship's DCN map
CHECK_SHAPE = (2, 16, 24, 8, 6)     # the JAX tools' own check: B, H, W, Cin, Cout
# a block's shared memory on an H100 SM, the budget blocks share there
SMEM_PER_SM = 233472


def check_inputs(dtype, device, with_bias=False, seed=1):
    """The JAX tools' check data at CHECK_SHAPE: x ~ N(0, 1), offsets
    U(-4, 4) (in and beyond the +/-2 px reach), mask U(0, 1), weight
    N(0, 0.1^2); with_bias adds a float32 bias N(0, 1)."""
    B, Hc, Wc, C, O = CHECK_SHAPE
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, Hc, Wc, C, generator=g)
    off = (torch.rand(B, Hc, Wc, 18, generator=g) * 2 - 1) * 4.0
    mask = torch.rand(B, Hc, Wc, 9, generator=g)
    w = torch.randn(3, 3, C, O, generator=g) * 0.1
    args = [t.to(device, dtype).contiguous() for t in (x, off, mask, w)]
    if with_bias:
        args.append(torch.randn(O, generator=g).to(device))
    return args


def hold(got, k1, plain, args) -> dict:
    """A variant's output `got` and K1's `k1` on `args` against their plain
    versions, by `compare`: the variant against `plain`, K1 against its own
    (`windowed_plain`). Where `plain` is not K1's (V1), K1's output must
    also fail the variant's limits: the control that they tell the two
    functions apart. Returns the three comparisons and `ok`."""
    with float32_exact():
        want = plain(*args)
        k1_want = want if plain is windowed_plain else windowed_plain(*args)
    held = {"variant": compare(got, want), "k1": compare(k1, k1_want),
            "control": None if plain is windowed_plain else compare(k1, want)}
    held["ok"] = held["variant"]["ok"] and held["k1"]["ok"] and \
        (held["control"] is None or not held["control"]["ok"])
    return held


def describe(held) -> str:
    """`hold`'s result as one line of text."""
    v, k, c =held["variant"], held["k1"], held["control"]
    text = (f"max |diff| from the plain version {v['max_abs_err']:.3e} (tol {v['tol']:.3e}), "
            f"differing {v['mismatch_share']:.3%} (limit {v['share_limit']:.0%}); K1 from its "
            f"own {k['max_abs_err']:.3e}, differing {k['mismatch_share']:.3%}")
    if c is not None:
        text += (f"; control, K1 from the variant's plain version: {c['max_abs_err']:.3e}, "
                 f"differing {c['mismatch_share']:.3%}, "
                 f"{'fails the limits' if not c['ok'] else 'WITHIN the limits'}")
    return text


def check(variant, plain, device=None, bias_cases=(False,), bitwise_to=None,
          bitwise_name="the Hopper K1") -> dict:
    """`variant` against `plain` at CHECK_SHAPE in float32 and bf16 (and with
    a bias for each of `bias_cases` that is True), by `hold` (K1's plain
    version stands for K1); with `bitwise_to`, a kernel (`bitwise_name`)
    whose bits the variant must give (on the CPU both are the plain
    version). Prints each case; returns {case: max |diff|}; raises
    RuntimeError on a disagreement."""
    dev = resolve_device(device)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for with_bias in bias_cases:
            args = check_inputs(dtype, dev, with_bias)
            got = variant(*args)
            held = hold(got, cuda_deform.deform_fwd_simt(*args), plain, args)
            same = bitwise_to is None or torch.equal(got, bitwise_to(*args))
            case = f"{str(dtype)[6:]}{' bias' if with_bias else ''}"
            text = describe(held) + ("" if bitwise_to is None else
                                     f"; {'bitwise equal to' if same else 'DIFFERS from'} "
                                     f"{bitwise_name}")
            print(f"check {case} {tuple(got.shape)} on {dev}: {text} "
                  f"{'ok' if held['ok'] and same else 'FAIL'}", flush=True)
            if not (held["ok"] and same):
                raise RuntimeError(f"the variant disagrees with its plain version or its "
                                   f"bitwise reference ({case})")
            errs[case] = held["variant"]["max_abs_err"]
    return errs


def generator():
    """A seeded generator on the card, for the A/B data (raises without one)."""
    return torch.Generator(device=resolve_device()).manual_seed(0)


def normal(g, shape, std):
    return torch.randn(shape, generator=g, device=g.device) * std


def uniform(g, shape, lo, hi):
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def skip_firing(kind: str, offset, mask):
    """Offsets and mask on which V4's skips fire (checks of the skips, not
    user data): "integer offsets" rounds the offsets to {-2, ..., 2}, so fy
    and fx are exactly 0 and three corners in four have weight 0; "dead
    taps" zeroes the mask of tap k over every 16-pixel run n of an image
    with (n + k) % 3 == 0 (the Hopper K1's items), so a third of the (item,
    tap) pairs have no live corner."""
    if kind == "integer offsets":
        return offset.round().clamp(-2, 2), mask
    H, W = mask.shape[1:3]
    run = torch.arange(H * W, device=mask.device) // 16
    dead = (run[:, None] + torch.arange(9, device=mask.device)) % 3 == 0
    return offset, mask * ~dead.reshape(1, H, W, 9)


def bf16(*ts):
    return [t.to(torch.bfloat16).contiguous() for t in ts]


def occupancy(smem: int, threads: int = 256) -> int:
    """Blocks of `smem` bytes and `threads` threads that fit on one SM, by
    shared memory (1 KB reserved per block) and threads; registers aside."""
    return min(SMEM_PER_SM // (smem + 1024), 2048 // threads)


def ab(label: str, name: str, variant, plain, args, iters=5, windows=3,
       plain_images=8) -> dict:
    """K1 against `variant` on the same bf16 inputs: times in turns (K1,
    variant, variant, K1; min over windows of each, CUDA events), the ratio
    K1 / variant and the variant's largest absolute and relative difference
    from K1. Both kernels' outputs on all of `args` are held on their first
    `plain_images` images against their plain versions (`hold`, with the
    variant's `plain`); raises RuntimeError on a disagreement. Prints two
    lines and returns the row as a dict."""
    x, _, _, w = args
    B, Hx, Wx, C = x.shape
    O = w.shape[3]
    k1 = cuda_deform.deform_fwd_simt(*args)
    got = variant(*args)
    n = min(plain_images, B)
    held = hold(got[:n], k1[:n], plain, [t[:n] for t in args[:3]] + [w])
    d = (got.float() - k1.float()).abs().max().item()
    rel = d / max(k1.float().abs().max().item(), 1e-30)
    del k1, got
    shape = f"({B},{Hx},{Wx},{C}->{O}) bf16"
    print(f"{label} {shape}, first {n} images: {name} {describe(held)} "
          f"{'ok' if held['ok'] else 'FAIL'}", flush=True)
    if not held["ok"]:
        raise RuntimeError(f"{name} or K1 disagrees with its plain version ({label})")
    times = {"K1": [], name: []}
    for who in ("K1", name, name, "K1"):
        fn = (lambda: cuda_deform.deform_fwd_simt(*args)) if who == "K1" else \
            (lambda: variant(*args))
        times[who].append(cuda_time_ms(fn, iters=iters, windows=windows))
    k1_ms, v_ms = min(times["K1"]), min(times[name])
    bound_ms, bound_by = deform_fwd_bound_ms(B, Hx, Wx, C, O, "bfloat16")
    control = held["control"]
    row = {"case": label, "variant": name, "shape": shape,
           "k1_ms": k1_ms, "ms": v_ms, "ratio": k1_ms / v_ms, "max_abs_diff": d,
           "max_rel_diff": rel, "bound_ms": bound_ms, "bound_by": bound_by,
           "plain_images": n, "max_abs_err": held["variant"]["max_abs_err"],
           "mismatch_share": held["variant"]["mismatch_share"],
           "k1_max_abs_err": held["k1"]["max_abs_err"],
           "k1_mismatch_share": held["k1"]["mismatch_share"],
           "control_mismatch_share": None if control is None else control["mismatch_share"]}
    print(f"{label} {shape}: {name} {v_ms:.4f} ms vs K1 {k1_ms:.4f} ms "
          f"({row['ratio']:.3f}x), max|d| {d:.3e}, max rel {rel:.3e}, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return row


def ab_hopper(label: str, name: str, args, iters=5, windows=3, plain_images=8) -> dict:
    """The Hopper variant `name` (a key of FIRST_DESIGNS) in turns against its
    first design and the Hopper K1 on the same bf16 inputs: SIMT V, Hopper
    V, Hopper K1, Hopper K1, Hopper V, SIMT V (min over windows of each,
    CUDA events). Its output must give the Hopper K1's bits on all of
    `args`, and it is held against its plain version on the first
    `plain_images` images (`compare`); raises RuntimeError otherwise. Counts
    the Hopper K1's launches made here as its baseline
    (`hopper_k1_launches`). Prints two lines and returns the row as a
    dict."""
    hopper, _ = VARIANTS[name]
    simt_name, simt, _ = FIRST_DESIGNS[name]
    x, _, _, w = args
    B, Hx, Wx, C = x.shape
    O = w.shape[3]
    k1_before = cuda_deform.launches
    got, k1 = hopper(*args), cuda_deform.deform_fwd(*args)
    same = torch.equal(got, k1)
    n = min(plain_images, B)
    with float32_exact():
        held = compare(got[:n], windowed_plain(*[t[:n] for t in args[:3]], w))
    del got, k1
    shape = f"({B},{Hx},{Wx},{C}->{O}) bf16"
    ok = same and held["ok"]
    print(f"{label} {shape}: {name} {'bitwise equal to' if same else 'DIFFERS from'} the "
          f"Hopper K1; first {n} images against the plain version: max |diff| "
          f"{held['max_abs_err']:.3e} (tol {held['tol']:.3e}), differing "
          f"{held['mismatch_share']:.3%} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{name} differs from the Hopper K1 or its plain version ({label})")
    fns = {"simt": lambda: simt(*args), "hopper": lambda: hopper(*args),
           "k1": lambda: cuda_deform.deform_fwd(*args)}
    times = {who: [] for who in fns}
    for who in ("simt", "hopper", "k1", "k1", "hopper", "simt"):
        times[who].append(cuda_time_ms(fns[who], iters=iters, windows=windows))
    ms, simt_ms, k1_ms = min(times["hopper"]), min(times["simt"]), min(times["k1"])
    bound_ms, bound_by = deform_fwd_bound_ms(B, Hx, Wx, C, O, "bfloat16")
    row = {"case": label, "variant": name, "simt": simt_name, "shape": shape, "ms": ms,
           "simt_ms": simt_ms, "hopper_k1_ms": k1_ms, "simt_over_hopper": simt_ms / ms,
           "k1_over_variant": k1_ms / ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms, "simt_share_of_bound": bound_ms / simt_ms,
           "bitwise_to_hopper_k1": same, "plain_images": n,
           "max_abs_err": held["max_abs_err"], "mismatch_share": held["mismatch_share"],
           "hopper_k1_launches": cuda_deform.launches - k1_before}
    print(f"{label} {shape}: {name} " + " / ".join(f"{t:.4f}" for t in times["hopper"]) +
          " ms, its SIMT design " + " / ".join(f"{t:.4f}" for t in times["simt"]) +
          f" ms ({row['simt_over_hopper']:.3f}x), the Hopper K1 " +
          " / ".join(f"{t:.4f}" for t in times["k1"]) +
          f" ms (K1 / variant {row['k1_over_variant']:.3f}); bound {bound_ms:.5f} ms "
          f"({bound_by}): at {row['share_of_bound']:.2%} of it, SIMT at "
          f"{row['simt_share_of_bound']:.2%}", flush=True)
    return row


def main(argv, doc: str, check_fn, bench_fn) -> int:
    """`[check|bench] [--device D]`: check (default) runs `check_fn(device)`,
    on the card unless `--device cpu`; bench runs `bench_fn()` on the card.
    Prints the result as one JSON line."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=("check", "bench"), default="check")
    ap.add_argument("--device", default=None,
                    help="check only: the device to check on (default: the card)")
    args = ap.parse_args(argv)
    if args.mode == "bench":
        if args.device not in (None, "cuda"):
            ap.error("bench runs on the card only")
        resolve_device()
        print(f"gpu: {gpu_name_and_power()}", flush=True)
        result = bench_fn()
    else:
        result = check_fn(args.device)
    print(json.dumps(result))
    return 0
