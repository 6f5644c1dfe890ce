"""Plain PyTorch versions of the five K1 variants (`csrc/deform_fwd_variants.cu`,
wrapped by `ops/cuda_deform_variants.py`, which routes CPU tensors here), and
`compare`, the limits a variant's output is held to against its plain version.

Each variant is the Hopper counterpart of one TPU prototype of the DCNv2
forward (the repo-root `tools/proto_deform_*.py`). All are windowed only.

* V1, `deform_fwd_bf16_fma` (`tools/proto_deform_bf16_fma.py`), computes a
  function of its own: every corner weight is rounded to bf16 and every
  corner product is taken in x's type before the float32 accumulation. Its
  plain version is `deform_bf16_fma_plain` below.
* V2 `deform_qxhoist`, V3 `deform_cvt1` (`tools/proto_deform_qxhoist.py`),
  V4 `deform_fwd_slot_skip` (`tools/proto_deform_slot_skip.py`) and V5
  `deform_fwd_tapwalk` (`tools/proto_deform_tapwalk.py`) compute K1's
  windowed function: their plain version, `windowed_plain`, is a call of
  K1's own, `ops/deform.modulated_deform_conv2d_plain(..., "windowed")`.
"""
from __future__ import annotations

import torch

from .deform import _corners, _sample_fields, modulated_deform_conv2d_plain

# bf16: the largest share of output elements that may differ from the plain
# version. A kernel and its plain version compute the same float32 values up
# to the order of the contraction's sums, so they round to different bf16
# values only where that order straddles a rounding edge (about 2e-4 of the
# elements at the phase-3 shapes); a kernel that computes the other function
# (V1's with K1's arithmetic, or K1's with V1's) differs in about half of
# them, while its largest difference can stay within two bf16 roundings.
MISMATCH_LIMIT = 0.01


def windowed_plain(x, offset, mask, weight, bias=None):
    """K1's windowed plain version, the plain version of V2-V5."""
    return modulated_deform_conv2d_plain(x, offset, mask, weight, bias, "windowed")


def tolerance(want: torch.Tensor) -> float:
    """The largest absolute difference from the plain version's `want`:
    float32 1e-4, far above two float32 sums of the same terms in other
    orders and far below any sampling mistake; bf16 two bf16 roundings
    (2^-8 relative) of the largest output, since each side rounds once."""
    if want.dtype == torch.float32:
        return 1e-4
    return 2 * 2 ** -8 * want.float().abs().max().item()


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """`got`, a kernel's output, against `want`, its plain version's on the
    same inputs: the largest absolute difference and its `tolerance`, the
    share of elements that differ and, in bf16, its limit MISMATCH_LIMIT;
    `ok` when got is finite, of want's type and within both limits."""
    err = (got.float() - want.float()).abs().max().item()
    share = (got != want).float().mean().item()
    tol = tolerance(want)
    share_limit = 1.0 if want.dtype == torch.float32 else MISMATCH_LIMIT
    ok = bool(torch.isfinite(got).all()) and got.dtype == want.dtype and err <= tol and \
        share <= share_limit
    return {"max_abs_err": err, "tol": tol, "mismatch_share": share,
            "share_limit": share_limit, "ok": ok}


def skip_shares(offset: torch.Tensor, mask: torch.Tensor) -> dict:
    """What V4 (`deform_fwd_slot_skip`) skips beyond K1 on these offsets and
    mask, from K1's windowed fields (`_sample_fields`), each corner weight
    ``(ay * ax) * wv`` in float32 as the kernels take it. `zero_corners`: the
    share of the corners K1 gathers (inside the image, of a tap with
    wv != 0) whose weight is exactly 0, which V4 neither copies nor adds;
    `dead_taps`: the share of (item, tap) pairs, an item being 16
    consecutive pixels of an image (the last one of an image may be
    shorter), with no corner of non-zero weight left, whose combine and
    products V4 skips."""
    B, H, W, _ = offset.shape
    P = H * W
    y0, fy, x0, fx, wv = _sample_fields(offset, mask, True)[:5]
    gathered, kept = [], []
    for _, _, _, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        k1 = (inb > 0) & (wv != 0)
        gathered.append(k1)
        kept.append(k1 & (ay * ax * wv != 0))
    gathered, kept = torch.stack(gathered, -1), torch.stack(kept, -1)   # (B, P, 9, 4)
    tiles = -(-P // 16)
    live = torch.zeros(B, tiles * 16, 9, dtype=torch.bool, device=offset.device)
    live[:, :P] = kept.any(-1)
    n = gathered.sum().item()
    return {"zero_corners": (gathered & ~kept).sum().item() / max(n, 1),
            "dead_taps": (~live.reshape(B, tiles, 16, 9).any(2)).float().mean().item()}


def deform_bf16_fma_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """V1's function: DCNv2 forward, windowed, NHWC, no bias.

    The fields are K1's (`_sample_fields`). Each corner's weight
    ``(ay * ax) * wv`` is taken in float32 and rounded to bf16; the product
    with the corner's x value is taken in x's type (bf16 x bf16 rounds to
    bf16; for float32 x it is bf16(w) * x in float32, JAX's promotion); the
    products are summed in float32 in the corner order (0, 0), (0, 1),
    (1, 0), (1, 1), the order of the prototype's slot walk, and the sum is
    contracted with the weight in float32. Returns (B, H, W, Cout) in x's
    type.
    """
    B, H, W, Cin = x.shape
    Cout = weight.shape[3]
    P, K = H * W, 9
    y0, fy, x0, fx, wv = _sample_fields(offset, mask, True)[:5]
    xs = x.reshape(B, P, Cin)
    sampled = torch.zeros(B, P * K, Cin, dtype=torch.float32, device=x.device)
    for _, _, idx, inb, ay, ax in _corners(y0, fy, x0, fx, H, W):
        cw = (ay * ax * wv).to(torch.bfloat16).to(x.dtype).reshape(B, P * K, 1)
        g = torch.gather(xs, 1, idx.reshape(B, P * K, 1).expand(-1, -1, Cin))
        prod = (cw * g).float()
        sampled += torch.where(inb.reshape(B, P * K, 1) > 0, prod, 0.0)
    out = sampled.reshape(B, P, K * Cin) @ weight.reshape(K * Cin, Cout).float()
    return out.reshape(B, H, W, Cout).to(x.dtype)
