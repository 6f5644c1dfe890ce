"""The Hopper V4 and V5 (`csrc/deform_fwd_tc_variants.cu`) on the CPU: their
plan, what V4's skips rest on, and V5's schedule of copies and buffers.

The kernels run only on the card, where `chip_smoke.py` holds them bit for
bit to the Hopper K1; their plain version is K1's (`windowed_plain`), which
`test_torch_deform_variants.py` holds against the JAX prototypes (and there
the wrappers' CPU route, `_simt` designs included). Checked here:

* `tc_plan` (warps, items per warp, blocks, bytes) at C 8 to 128 in both
  types: within a block's shared memory, V4's the Hopper K1's resident plan
  byte for byte, V5's with more warps than that plan at C 64, and a shape
  that does not fit raises;
* V4's skips on K1's windowed fields in float32 (`ops/deform.py`
  `_sample_fields`): the terms it drops are exact zeros, and dropping them
  (corners of weight 0, taps with no live corner in a 16-pixel item) leaves
  K1's samples bit for bit and its output value for value, on integer
  offsets, on masks with dead taps and on the tools' offset distributions;
  with the share of corners skipped on each;
* `_walk` follows `tapwalk_kernel`'s loop over (tap, item) pairs step by
  step and checks that every pair reads corners and a weight slice that
  have landed and that nothing is overwritten while it is still to be read.
  A change to that loop must be made in `_walk` too.

Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu_torch.ops import cuda_deform_variants as cdv
from mgdt_yolo_tpu_torch.ops.deform import _corners, _sample_fields
from mgdt_yolo_tpu_torch.ops.deform_variants import skip_shares
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAX_SMEM = 232448           # shared memory one block may use on an H100
SMS = 132                   # an H100's SMs
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the Hopper K1's resident plan at C 32 -> 32 (chip_smoke.py C32_SMEM):
# (warps, bytes)
K1_RESIDENT_C32 = {"float32": (8, 219648), "bfloat16": (16, 225280)}


def _plan(kernel, C, dtype, B=32, H=80, W=80):
    return cdv.tc_plan(kernel, B, H, W, C, C, DTYPES[dtype], SMS)


def _fit(C, dtype, items_per_warp):
    """V5's warps at C -> C with this many items a warp: as many as fit, at
    most its launch bound's."""
    lay = cdv.tc_layout(C, C, 4 if dtype == "float32" else 2, 2, 0, items_per_warp)
    return min(cdv.TC_MAX_WARPS[items_per_warp],
               (MAX_SMEM - lay["smem"]) // lay["warp_bytes"])


@pytest.mark.parametrize("C", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tapwalk_plan_fits_a_block(dtype, C):
    plan = _plan("deform_fwd_tapwalk", C, dtype)
    ipw, warps = plan["items_per_warp"], plan["warps"]
    assert plan["smem"] <= MAX_SMEM
    assert plan["smem"] == plan["weight_bytes"] + warps * plan["warp_bytes"]
    # two taps' slices (hi, and lo for float32) of (Cout padded to 8, Cin
    # padded to 16 plus 8) bf16
    parts = 2 if dtype == "float32" else 1
    NP, SA = -(-C // 8) * 8, -(-C // 16) * 16 + 8
    assert plan["weight_bytes"] == 2 * parts * NP * SA * 2
    assert plan["weight_scratch"] == parts * 9 * NP * SA
    # the most warps that fit, at most the launch bound of its items per warp
    assert 1 <= warps <= cdv.TC_MAX_WARPS[ipw]
    assert warps == cdv.TC_MAX_WARPS[ipw] or \
        plan["smem"] + plan["warp_bytes"] > MAX_SMEM
    # two items a warp only where they cost no warp
    assert warps == _fit(C, dtype, 1) if ipw == 2 else warps > _fit(C, dtype, 2)
    rounds = -(-plan["items"] // (warps * ipw))
    assert 1 <= plan["blocks"] <= min(rounds, SMS * 16)
    assert plan["items"] == 32 * 400 * -(-C // 32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tapwalk_has_more_warps_than_k1_resident_at_c64(dtype):
    v5 = _plan("deform_fwd_tapwalk", 64, dtype)
    k1 = _plan("deform_fwd_slot_skip", 64, dtype)    # V4's plan: K1's resident one
    assert v5["warps"] > k1["warps"]
    assert v5["items_per_warp"] == 2
    assert (v5["warps"], k1["warps"]) == ((9, 6) if dtype == "bfloat16" else (4, 1))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slot_skip_plan_is_k1_resident_plan(dtype):
    plan = _plan("deform_fwd_slot_skip", 32, dtype)
    assert (plan["warps"], plan["smem"]) == K1_RESIDENT_C32[dtype]
    assert plan["items_per_warp"] == 1
    # its layout's weight is the 9 taps'
    assert plan["weight_bytes"] == 9 * 32 * 40 * 2 * (2 if dtype == "float32" else 1)


@pytest.mark.parametrize("kernel, C, dtype", [("deform_fwd_slot_skip", 128, "bfloat16"),
                                              ("deform_fwd_slot_skip", 96, "float32"),
                                              ("deform_fwd_tapwalk", 256, "float32")])
def test_plan_refuses_what_does_not_fit(kernel, C, dtype):
    with pytest.raises(ValueError, match="not one warp fits"):
        _plan(kernel, C, dtype)


def test_each_tc_variant_has_its_first_design():
    assert set(cdv.TC_KERNELS) <= set(cdv.FIRST_DESIGNS)
    for name in cdv.TC_KERNELS:
        simt, fn, _ = cdv.FIRST_DESIGNS[name]
        assert simt == f"{name}_simt" and fn.__name__ == simt and simt in cdv.launches


# ---------------------------------------------------------------- V4's skips

def _inputs(kind, seed=0, B=2, H=24, W=32, C=8, O=16):
    """float32 inputs: x ~ N(0, 1), weight N(0, 0.1^2), mask U(0, 1) (the
    tools': sigmoid(N(0, 1))), offsets by `kind`: "integer" from {-2..2},
    "dead taps" U(-1.5, 1.5) with the mask 0 for tap k over every 16-pixel
    run n of an image with (n + k) % 3 == 0, or the tools' N(0, 0.1^2),
    N(0, 0.7^2) and N(0, 0.7^2) clipped to +-2, rounded to bf16 as they
    reach the kernels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) * 0.1).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, 9)).astype(np.float32)
    shape = (B, H, W, 18)
    if kind == "integer":
        off = rng.integers(-2, 3, shape).astype(np.float32)
    elif kind == "dead taps":
        off = rng.uniform(-1.5, 1.5, shape).astype(np.float32)
        run = np.arange(H * W) // 16
        dead = (run[:, None] + np.arange(9)) % 3 == 0
        mask = mask * ~dead.reshape(1, H, W, 9)
    else:
        std, clip = {"small-off": (0.1, None), "big-off": (0.7, None),
                     "clamped +-2": (0.7, 2.0)}[kind]
        off = rng.standard_normal(shape).astype(np.float32) * std
        if clip is not None:
            off = np.clip(off, -clip, clip)
        mask = 1 / (1 + np.exp(-rng.standard_normal((B, H, W, 9)))).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (x, off, mask, w)]
    if kind not in ("integer", "dead taps"):
        ts = [t.to(torch.bfloat16).float() for t in ts]
    return ts


def _samples(x, off, mask, skip):
    """K1's samples (B, P, 9, Cin) in float32: each (pixel, tap)'s live
    corners added from +0 in K1's order, the corner weights (ay * ax) * wv.
    K1 drops a corner outside the image or of a dead tap; with `skip`, V4
    also drops one of weight exactly 0. Also returns the corner weights and
    which corners are kept, (B, P, 9, 4)."""
    B, H, W, C = x.shape
    y0, fy, x0, fx, wv = _sample_fields(off, mask, True)[:5]
    xf = x.reshape(B, H * W, C)
    s = torch.zeros(B, H * W * 9, C)
    weights, kept = [], []
    for _, _, idx, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        wq = ay * ax * wv
        live = (inb > 0) & (wv != 0)
        if skip:
            live = live & (wq != 0)
        g = torch.gather(xf, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        s = torch.where(live.reshape(B, -1, 1), s + wq.reshape(B, -1, 1) * g, s)
        weights.append(wq)
        kept.append(live)
    return s.reshape(B, H * W, 9, C), torch.stack(weights, -1), torch.stack(kept, -1)


def _contract(s, kept, weight, skip_dead):
    """The contraction tap by tap in float32, K1's tap order; with
    `skip_dead`, a tap with no kept corner over a 16-pixel item adds nothing
    to that item's sums (V4 skips its combine and products)."""
    B, P, K, C = s.shape
    tiles = -(-P // 16)
    live = torch.zeros(B, tiles * 16, K, dtype=torch.bool)
    live[:, :P] = kept.any(-1)
    item_live = live.reshape(B, tiles, 16, K).any(2).repeat_interleave(16, 1)[:, :P]
    out = torch.zeros(B, P, weight.shape[3])
    for k in range(K):
        term = s[:, :, k] @ weight[k // 3, k % 3]
        out = torch.where(item_live[:, :, k:k + 1], out + term, out) if skip_dead else out + term
    return out, (~item_live).float().mean().item()


KINDS = ["integer", "dead taps", "small-off", "big-off", "clamped +-2"]


@pytest.mark.parametrize("kind", KINDS)
def test_slot_skip_drops_only_exact_zeros(kind):
    x, off, mask, w = _inputs(kind)
    k1, weights, k1_kept = _samples(x, off, mask, skip=False)
    v4, _, v4_kept = _samples(x, off, mask, skip=True)
    dropped = k1_kept & ~v4_kept
    assert (weights[dropped] == 0).all()        # the terms V4 skips are exact zeros
    assert torch.equal(k1.view(torch.int32), v4.view(torch.int32))   # samples, bit for bit
    k1_out, _ = _contract(k1, k1_kept, w, skip_dead=False)
    v4_out, dead = _contract(v4, v4_kept, w, skip_dead=True)
    assert torch.equal(k1_out, v4_out)
    shares = skip_shares(off, mask)
    assert shares["zero_corners"] == dropped.sum().item() / k1_kept.sum().item()
    assert shares["dead_taps"] == pytest.approx(
        (~torch.nn.functional.pad(v4_kept.any(-1), (0, 0, 0, (-x.shape[1] * x.shape[2]) % 16))
         .reshape(x.shape[0], -1, 16, 9).any(2)).float().mean().item())
    if kind == "integer":
        assert shares["zero_corners"] > 0.7     # 3 of 4 corners, less those outside
    if kind == "dead taps":
        assert shares["dead_taps"] > 0.25 and dead > 0.25


def test_skip_shares_tool_offsets_against_integer():
    """What V4 skips on the tools' offsets against integer ones (printed;
    `pytest -s` shows it): almost nothing on N(0, 0.1^2), a fraction of a
    percent where N(0, 0.7^2) offsets fall below -2 (the clamp makes fy
    exactly 0), three corners in four on integer offsets; no dead tap on the
    tools' masks."""
    shares = {kind: skip_shares(*_inputs(kind, seed=1, B=4, H=80, W=80)[1:3])
              for kind in ("small-off", "big-off", "clamped +-2", "integer")}
    for kind, s in shares.items():
        print(f"{kind}: {s['zero_corners']:.4%} of the corners K1 gathers skipped, "
              f"{s['dead_taps']:.4%} of the (item, tap) pairs")
    assert shares["small-off"]["zero_corners"] < 1e-4
    assert 1e-3 < shares["big-off"]["zero_corners"] < 2e-2
    assert 1e-3 < shares["clamped +-2"]["zero_corners"] < 2e-2
    assert shares["integer"]["zero_corners"] > 0.7
    assert all(shares[k]["dead_taps"] == 0 for k in ("small-off", "big-off", "clamped +-2"))


# ---------------------------------------------------------------- V5's schedule

def _walk(ipw, nlive_by_round):
    """One warp's walk of `tapwalk_kernel`'s loop with `ipw` items a warp
    over rounds whose live items are `nlive_by_round`, tracking the warp's
    cp.async groups (a list of (kind, id): "G" a pair's corners, "S" a
    tap's slice), its two tap buffers and the block's two weight buffers.
    Checks at every step that a pair reads corners and a slice that have
    landed, that a copy never overwrites what is still to be read, and that
    no corner copy is in flight at an epilogue. Returns the pairs computed,
    as (round, tap, item)."""
    groups, landed = [], set()
    tap_buf = [None, None]      # the pair whose corners each tap buffer holds
    w_buf = [None, None]        # the tap whose slice each weight buffer holds
    done, computed = set(), []

    def commit(*copies):
        groups.append(list(copies))

    def wait(n):                # cp.async.wait_group n
        while len(groups) > n:
            landed.update(groups.pop(0))

    def gather(pair, buf):
        held = tap_buf[buf]
        assert held is None or held in done, f"{pair} overwrites {held} before its combine"
        tap_buf[buf] = pair
        return ("G", pair)

    def load_slice(t, k):       # slice of tap k (None: none) for block tap t
        if k is None:
            commit()
            return
        assert w_buf[t & 1] is None or w_buf[t & 1][0] <= t - 2, "slice overwritten in use"
        w_buf[t & 1] = (t, k)
        commit(("S", t))

    def compute(pair, j, t):
        assert tap_buf[j & 1] == pair and ("G", pair) in landed, f"{pair} not landed"
        assert w_buf[t & 1] == (t, pair[1]) and ("S", t) in landed, f"slice {t} not landed"
        done.add(pair)
        computed.append(pair)

    t = 0
    rounds = len(nlive_by_round)
    load_slice(0, 0)
    for r, nlive in enumerate(nlive_by_round):
        j = 0
        if nlive > 0:
            commit(gather((r, 0, 0), 0))
        else:
            commit()
        for k in range(9):
            wait(0)             # then the block barrier
            copies = []
            if nlive > 0:
                if nlive > 1:
                    copies.append(gather((r, k, 1), (j + 1) & 1))
                elif k + 1 < 9:
                    copies.append(gather((r, k + 1, 0), (j + 1) & 1))
            commit(*copies)
            load_slice(t + 1, k + 1 if k + 1 < 9 else (0 if r + 1 < rounds else None))
            if nlive > 0:
                compute((r, k, 0), j, t)
                j += 1
            for i in range(1, ipw):
                if i < nlive:
                    copies = []
                    if i + 1 < nlive:
                        copies.append(gather((r, k, i + 1), (j + 1) & 1))
                    elif k + 1 < 9:
                        copies.append(gather((r, k + 1, 0), (j + 1) & 1))
                    commit(*copies)
                    wait(2)
                    compute((r, k, i), j, t)
                    j += 1
            t += 1
        pending = [c for g in groups for c in g if c[0] == "G"]
        assert not pending, f"corner copies in flight at the epilogue: {pending}"
    return computed


@pytest.mark.parametrize("ipw, nlive_by_round", [(1, [1, 1, 1]), (1, [1, 0]),
                                                 (2, [2, 2, 2]), (2, [2, 1]), (2, [1, 0]),
                                                 (2, [0])])
def test_tapwalk_schedule(ipw, nlive_by_round):
    got = _walk(ipw, nlive_by_round)
    want = [(r, k, i) for r, n in enumerate(nlive_by_round) for k in range(9) for i in range(n)]
    assert got == want      # every live item's 9 taps, in tap order
