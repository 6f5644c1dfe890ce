"""The Hopper V2 and V3 (`csrc/deform_fwd_slab.cu`) on the CPU: their plan
and the schedule of their ring of input rows.

The kernels run only on the card, where `chip_smoke.py` holds them bit for
bit to the Hopper K1; their plain version is K1's (`windowed_plain`), which
`test_torch_deform_variants.py` holds against the JAX prototypes. What is
checked here is what the kernels take from Python: `slab_plan` (rows per
band, ring rows, warps, blocks, bytes) at the widths the port uses, and that
the band walk the kernel runs with that plan finds every input row a band
reads in its ring slot, with the next band's rows landing while it is
computed. `_walk` follows the kernel's loop (`slab_kernel`) step by step.
The wrappers' CPU route is held with the other variants' in
`test_torch_deform_variants.py`.
"""
import pytest
import torch

from mgdt_yolo_tpu_torch.ops import cuda_deform_variants as cdv
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAX_SMEM = 232448           # shared memory one block may use on an H100
SMS = 132                   # an H100's SMs
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _plan(kernel, B, H, W, C, dtype, sms=SMS):
    return cdv.slab_plan(kernel, B, H, W, C, C, DTYPES[dtype], sms)


@pytest.mark.parametrize("W", [24, 80])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", cdv.SLAB_KERNELS)
def test_plan_fits_a_block(kernel, dtype, C, W):
    H = W
    plan = _plan(kernel, 32, H, W, C, dtype)
    assert plan is not None
    assert plan["smem"] <= MAX_SMEM
    es = 2 if dtype == "bfloat16" else 4
    ss = es if kernel == "deform_fwd_qxhoist" else 4
    assert plan["convert"] == (es != ss)
    # the layout adds up, and the ring holds what the schedule needs
    parts = ("weight_bytes", "ring_bytes", "stage_bytes")
    assert plan["smem"] == sum(plan[k] for k in parts) + plan["warps"] * plan["warp_bytes"]
    row = -(-W * C * ss // 16) * 16
    assert plan["ring_bytes"] == plan["ring_rows"] * row + -(-C * ss // 16) * 16
    need = plan["rb"] + 7 if plan["convert"] else 2 * plan["rb"] + 7
    assert plan["ring_rows"] == min(need, H)
    assert plan["stage_bytes"] == (plan["rb"] * -(-W * C * es // 16) * 16
                                   if plan["convert"] else 0)
    # warps: at most 16 and a band's items, at least 8 where a band has them
    items = -(-plan["rb"] * W // 16) * -(-C // 32)
    assert 1 <= plan["warps"] <= min(16, items)
    assert plan["warps"] >= min(cdv.SLAB_MIN_WARPS, items)
    assert 1 <= plan["blocks"] <= min(plan["bands"], SMS * 16)
    assert plan["bands"] == 32 * -(-H // plan["rb"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", cdv.SLAB_KERNELS)
def test_plan_refuses_c64_at_the_flagship_width(kernel, dtype):
    assert _plan(kernel, 32, 80, 80, 64, dtype) is None


# the flagship's DCN shape, 80x80, C 32: (rb, ring rows, warps, bytes)
FLAGSHIP = {("deform_fwd_qxhoist", "bfloat16"): (8, 23, 16, 225856),
            ("deform_fwd_cvt1", "bfloat16"): (4, 11, 14, 230656),
            ("deform_fwd_qxhoist", "float32"): (2, 11, 10, 229248),
            ("deform_fwd_cvt1", "float32"): (2, 11, 10, 229248)}


@pytest.mark.parametrize("key", list(FLAGSHIP))
def test_flagship_plan(key):
    kernel, dtype = key
    plan = _plan(kernel, 32, 80, 80, 32, dtype)
    assert (plan["rb"], plan["ring_rows"], plan["warps"], plan["smem"]) == FLAGSHIP[key]
    # one block per SM, each a run of 2-3 of the batch's bands
    assert plan["blocks"] == SMS


def _walk(plan, rows, sms_blocks):
    """The kernel's band walk over x's rows (B, H, row) with `plan` and
    `sms_blocks` blocks: for every band, the rows it reads are checked in the
    slots it reads them from. The next band's new rows are written into the
    ring before the band reads (V2: they land while it is computed, so a slot
    they share with a row it reads would show), or into the stage, converted
    after the next band's barrier (V3 on bf16 x). Returns the bands walked."""
    B, H, _ = rows.shape
    RB, R = plan["rb"], plan["ring_rows"]
    NB = -(-H // RB)
    bands = B * NB
    walked = 0
    for blk in range(sms_blocks):
        first, last = bands * blk // sms_blocks, bands * (blk + 1) // sms_blocks
        ring = torch.full((R, rows.shape[2]), float("nan"))
        stage = []
        cur_b, prev_hi = -1, -1
        for n in range(first, last):
            b, j = divmod(n, NB)
            r0, r1 = j * RB, min(j * RB + RB, H)
            lo, hi = max(r0 - 3, 0), min(r1 + 3, H - 1)
            if b != cur_b:
                for y in range(lo, hi + 1):
                    ring[y % R] = rows[b, y]
                cur_b = b
            elif plan["convert"]:
                assert [y for y, _ in stage] == list(range(prev_hi + 1, hi + 1))
                for y, v in stage:
                    ring[y % R] = v
            if n + 1 < last and (n + 1) // NB == b:
                next_hi = min(min(r1 + RB, H) + 3, H - 1)
                new = [(y, rows[b, y]) for y in range(hi + 1, next_hi + 1)]
                assert len(new) <= RB
                if plan["convert"]:
                    stage = new
                else:
                    for y, v in new:
                        ring[y % R] = v
            prev_hi = hi
            slot_lo = lo % R
            for y in range(lo, hi + 1):
                slot = slot_lo + (y - lo)
                slot -= R if slot >= R else 0
                assert torch.equal(ring[slot], rows[b, y]), (n, y)
            walked += 1
    return walked


# (B, H, W, C, dtype): the flagship's map (each plan's RB), short images
# (fewer rows than a ring or a band) and a ragged one; blocks from 1 (one
# run over every image) to one per band
WALKS = [(3, 80, 80, 32, "bfloat16"), (3, 80, 80, 32, "float32"), (4, 5, 24, 8, "bfloat16"),
         (5, 16, 24, 8, "float32"), (3, 20, 28, 32, "bfloat16"), (2, 9, 12, 4, "float32")]


@pytest.mark.parametrize("blocks", [1, 2, 7, None])
@pytest.mark.parametrize("case", WALKS)
@pytest.mark.parametrize("kernel", cdv.SLAB_KERNELS)
def test_ring_holds_every_row_a_band_reads(kernel, case, blocks):
    B, H, W, C, dtype = case
    plan = _plan(kernel, B, H, W, C, dtype)
    rows = torch.arange(B * H * W * C, dtype=torch.float32).reshape(B, H, W * C)
    n = plan["bands"] if blocks is None else min(blocks, plan["bands"])
    assert _walk(plan, rows, n) == plan["bands"]


def test_each_slab_variant_has_its_first_design():
    assert set(cdv.SLAB_KERNELS) <= set(cdv.FIRST_DESIGNS)
    simt = {name: first for name, (first, _, _) in cdv.FIRST_DESIGNS.items()}
    assert {simt[k] for k in cdv.SLAB_KERNELS} == {"deform_fwd_qxhoist_simt",
                                                    "deform_fwd_cvt1_simt"}
    assert set(cdv.launches) == set(cdv.VARIANTS) | set(simt.values())
