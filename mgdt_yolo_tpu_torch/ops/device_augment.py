"""Training augmentation on the device: mosaic, scale/translate warp, flips
and HSV, the counterpart of `device_augment` in
`mgdt_yolo_tpu/ops/device_augment.py`.

The JAX function draws its random numbers from one key and applies them in
one jitted program; here the two halves are split. `augment_draws` makes
the draws from an explicit `torch.Generator` (JAX's threefry stream is not
reproduced, so the port's draws are its own), and `apply_augment` does
everything after them, operation for operation as the JAX code does, so a
test can feed it JAX's draws and hold its output to JAX's.

The warp composes the mosaic and the axis-aligned scale/translate in one
pass: per tile k, two batched bf16 matrix products with bilinear weight
matrices `Wy_k @ tile_k @ Wx_k^T`, summed over the four tiles in bf16, then
`114 * (1 - coverage)` fills what no tile covers (see the JAX module for why
this equals paste-then-warp). Flips, HSV and /255 are K3
(`ops/cuda_image.fused_augment`). Labels ride along; boxes the warp shrinks
away are dropped by the reference's `box_candidates` rule, and survivors are
compacted to `max_out` slots in their order.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import cuda_image
from .nms import _topk_stable

FILL = 114.0


def augment_draws(B: int, imgsz: int, generator: torch.Generator, mosaic_p: float = 1.0,
                  scale: float = 0.5, translate: float = 0.1, fliplr: float = 0.5,
                  flipud: float = 0.0, hsv_h: float = 0.015, hsv_s: float = 0.7,
                  hsv_v: float = 0.4) -> Dict[str, torch.Tensor]:
    """The random draws of one augmented batch of B images at `imgsz`, made
    on the CPU from `generator`, with the JAX draws' distributions:
    picks (B, 4) int32 (slot 0 the image itself, 1-3 uniform over the
    batch), centers (B, 2) uniform in [s/2, 3s/2), use_mosaic (B,) bool,
    sf (B,) uniform in [1 - scale, 1 + scale), tx, ty (B,) uniform in
    [(0.5 - translate) s, (0.5 + translate) s), flips (B, 2) int32
    [left-right, up-down] and gains (B, 3) float32 = 1 + U(-1, 1) * (h, s, v).
    """
    s, f32 = imgsz, torch.float32

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, dtype=f32) * (hi - lo) + lo

    picks = torch.cat([torch.arange(B, dtype=torch.int32)[:, None],
                       torch.randint(0, B, (B, 3), generator=generator, dtype=torch.int32)], 1)
    centers = uniform((B, 2), s / 2, 2 * s - s / 2)
    use_mosaic = torch.rand(B, generator=generator) < mosaic_p
    sf = uniform((B,), 1 - scale, 1 + scale)
    tx = uniform((B,), (0.5 - translate) * s, (0.5 + translate) * s)
    ty = uniform((B,), (0.5 - translate) * s, (0.5 + translate) * s)
    do_lr = torch.rand(B, generator=generator) < fliplr
    do_ud = torch.rand(B, generator=generator) < flipud
    flips = torch.stack([do_lr, do_ud], 1).to(torch.int32)
    gains = 1.0 + uniform((B, 3), -1.0, 1.0) * torch.tensor([hsv_h, hsv_s, hsv_v], dtype=f32)
    return {"picks": picks, "centers": centers, "use_mosaic": use_mosaic, "sf": sf,
            "tx": tx, "ty": ty, "flips": flips, "gains": gains}


def apply_augment(batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                  imgsz: int, max_out: int = 0) -> Dict[str, torch.Tensor]:
    """Augment a raw batch with `draws` (`augment_draws`' keys).

    batch: img (B, s, s, 3) uint8 RGB (content top-left anchored, 114 pad),
    img_hw (B, 2) content (h, w), gt_bboxes (B, G, 4) xyxy pixels,
    gt_labels (B, G), mask_gt (B, G). Returns img (B, s, s, 3) float32 in
    [0, 1] and the transformed labels compacted to `max_out` slots
    (default 4G, at most 4G).
    """
    imgs = batch["img"]
    dev = imgs.device
    d = {k: v.to(dev) for k, v in draws.items()}
    B, s = imgs.shape[0], imgsz
    G = batch["gt_bboxes"].shape[1]
    max_out = max_out or 4 * G
    if max_out > 4 * G:
        raise ValueError(f"max_out {max_out} exceeds the {4 * G} mosaic label slots")
    f32, i32 = torch.float32, torch.int32
    hws = batch["img_hw"].to(f32)
    off = s // 2  # raw-canvas origin shift vs reference-2s coordinates
    arange_b = torch.arange(B, dtype=i32, device=dev)
    use_mosaic = d["use_mosaic"]
    # solo (non-mosaic) images warp themselves: every slot is the image
    picks = torch.where(use_mosaic[:, None], d["picks"].to(i32), arange_b[:, None]).long()
    xc = d["centers"][:, 0].to(i32)  # reference-2s coords, truncated as astype
    yc = d["centers"][:, 1].to(i32)

    # per-tile content size and paste offsets (tile k's anchored corner at (yc, xc))
    hk = hws[picks]  # (B, 4, 2)
    h = hk[..., 0].to(i32)
    w = hk[..., 1].to(i32)
    oy = torch.stack([yc - h[:, 0], yc - h[:, 1], yc, yc], dim=1)
    ox = torch.stack([xc - w[:, 0], xc, xc - w[:, 2], xc], dim=1)

    # mosaic labels
    gt = batch["gt_bboxes"].to(f32)
    shift = torch.stack([ox, oy, ox, oy], dim=-1).to(f32)
    m_boxes = (gt[picks] + shift[:, :, None, :]).reshape(B, 4 * G, 4)
    m_labels = batch["gt_labels"][picks].reshape(B, 4 * G)
    m_mask = batch["mask_gt"][picks].reshape(B, 4 * G)
    # non-mosaic labels: the image centred on the 2s reference canvas
    solo_off = torch.stack([(3 * s - hws[:, 1]) / 2, (3 * s - hws[:, 0]) / 2], dim=1)
    solo_boxes = torch.cat([gt + torch.cat([solo_off, solo_off], 1)[:, None] - float(off),
                            torch.zeros((B, 3 * G, 4), dtype=f32, device=dev)], dim=1)
    solo_labels = torch.cat([batch["gt_labels"],
                             batch["gt_labels"].new_zeros((B, 3 * G))], dim=1)
    solo_mask = torch.cat([batch["mask_gt"],
                           torch.zeros((B, 3 * G), dtype=torch.bool, device=dev)], dim=1)
    m_boxes = torch.where(use_mosaic[:, None, None], m_boxes, solo_boxes)
    m_labels = torch.where(use_mosaic[:, None], m_labels, solo_labels)
    m_mask = torch.where(use_mosaic[:, None], m_mask, solo_mask)
    m_boxes = m_boxes.clamp(0.0, 2.0 * s)  # reference-coord clip pre-warp

    # fused mosaic + scale/translate warp: dst = sf * (src - s) + t
    sf, tx, ty = d["sf"].to(f32), d["tx"].to(f32), d["ty"].to(f32)
    dst = torch.arange(s, dtype=f32, device=dev)
    src_x = (dst[None] - tx[:, None]) / sf[:, None] + s + off  # (B, s) raw
    src_y = (dst[None] - ty[:, None]) / sf[:, None] + s + off

    # sampled region per tile: content rows/cols, tile k's quadrant and the
    # reference 2s crop [off, off + 2s); quadrant boundaries at (yc, xc) + off
    ycr, xcr = yc + off, xc + off
    ref_hi = off + 2 * s
    O_y, O_x = oy + off, ox + off
    lo = torch.tensor(off, dtype=i32, device=dev)
    hi = torch.tensor(ref_hi, dtype=i32, device=dev)
    row_lo = torch.stack([torch.maximum(O_y[:, 0], lo), torch.maximum(O_y[:, 1], lo),
                          ycr, ycr], dim=1)
    row_hi = torch.stack([ycr, ycr, torch.minimum(O_y[:, 2] + h[:, 2], hi),
                          torch.minimum(O_y[:, 3] + h[:, 3], hi)], dim=1)
    col_lo = torch.stack([torch.maximum(O_x[:, 0], lo), xcr,
                          torch.maximum(O_x[:, 2], lo), xcr], dim=1)
    col_hi = torch.stack([xcr, torch.minimum(O_x[:, 1] + w[:, 1], hi),
                          xcr, torch.minimum(O_x[:, 3] + w[:, 3], hi)], dim=1)
    # solo: only the k=3 term fires, centred, full content, no quadrants
    solo_oy = solo_off[:, 1].to(i32)
    solo_ox = solo_off[:, 0].to(i32)
    zero = torch.zeros_like(ycr)

    def pick_solo(mos, solo3, k):
        return torch.where(use_mosaic, mos[:, k], solo3 if k == 3 else zero)

    hs = hws[:, 0].to(i32)
    ws = hws[:, 1].to(i32)
    warped = cov = None
    u = torch.arange(s, dtype=f32, device=dev)
    for k in range(4):
        oyk, oxk = pick_solo(O_y, solo_oy, k), pick_solo(O_x, solo_ox, k)
        rlo, rhi = pick_solo(row_lo, solo_oy, k), pick_solo(row_hi, solo_oy + hs, k)
        clo, chi = pick_solo(col_lo, solo_ox, k), pick_solo(col_hi, solo_ox + ws, k)
        # bilinear weights against tile k's rows/cols, region-masked
        pos_y = oyk[:, None].to(f32) + u[None]  # (B, s) raw
        pos_x = oxk[:, None].to(f32) + u[None]
        my = (pos_y >= rlo[:, None]) & (pos_y < rhi[:, None])
        mx = (pos_x >= clo[:, None]) & (pos_x < chi[:, None])
        Wy = torch.clamp(1.0 - torch.abs(src_y[:, :, None] - pos_y[:, None, :]),
                         min=0.0) * my[:, None, :]  # (B, s_out, s_tile)
        Wx = torch.clamp(1.0 - torch.abs(src_x[:, :, None] - pos_x[:, None, :]),
                         min=0.0) * mx[:, None, :]
        covk = Wy.sum(-1)[:, :, None] * Wx.sum(-1)[:, None, :]
        cov = covk if cov is None else cov + covk
        tile = imgs[picks[:, k]].to(torch.bfloat16)  # (B, s, s, 3)
        t1 = torch.einsum("biu,buxc->bixc", Wy.to(torch.bfloat16), tile)
        term = torch.einsum("bjx,bixc->bijc", Wx.to(torch.bfloat16), t1)
        warped = term if warped is None else warped + term  # bf16, rounded per add
    warped = warped.to(f32) + (1.0 - torch.clamp(cov, 0, 1))[..., None] * FILL
    # contiguous for K3: on the card the second product's result, and so
    # `warped`, can be a permuted view
    img_u8 = torch.clamp(torch.round(warped), 0, 255).to(torch.uint8).contiguous()

    # boxes through the same map (reference-2s coords): dst = sf * (src - s) + t
    sfb, txb, tyb = sf[:, None], tx[:, None], ty[:, None]
    wb = torch.stack([sfb * (m_boxes[..., 0] - s) + txb, sfb * (m_boxes[..., 1] - s) + tyb,
                      sfb * (m_boxes[..., 2] - s) + txb, sfb * (m_boxes[..., 3] - s) + tyb], -1)
    w_before = m_boxes[..., 2] - m_boxes[..., 0]
    h_before = m_boxes[..., 3] - m_boxes[..., 1]
    wb = wb.clamp(0, s)
    w_after = wb[..., 2] - wb[..., 0]
    h_after = wb[..., 3] - wb[..., 1]
    # box_candidates (reference augment.py:469-476)
    ar = torch.maximum(w_after / (h_after + 1e-16), h_after / (w_after + 1e-16))
    keep = (w_after > 2) & (h_after > 2) & (ar < 100) & \
        (w_after * h_after / (w_before * sfb * h_before * sfb + 1e-16) > 0.1)
    m_mask = m_mask & keep

    # flips + HSV + normalise (K3)
    flips = d["flips"].to(i32).contiguous()
    img = cuda_image.fused_augment(img_u8, d["gains"].to(f32).contiguous(), flips)
    do_lr, do_ud = (flips[:, 0] > 0)[:, None], (flips[:, 1] > 0)[:, None]
    wb = torch.stack([torch.where(do_lr, s - wb[..., 2], wb[..., 0]),
                      torch.where(do_ud, s - wb[..., 3], wb[..., 1]),
                      torch.where(do_lr, s - wb[..., 0], wb[..., 2]),
                      torch.where(do_ud, s - wb[..., 1], wb[..., 3])], -1)

    # compact to max_out slots by validity, survivors in their order (the
    # JAX top_k over mask - index * 1e-6; ties cannot occur)
    order = m_mask.to(f32) - torch.arange(4 * G, dtype=f32, device=dev)[None] * 1e-6
    _, idx = _topk_stable(order, max_out)
    out_mask = torch.gather(m_mask, 1, idx)
    out_boxes = torch.gather(wb, 1, idx[..., None].expand(-1, -1, 4))
    out_labels = torch.gather(m_labels, 1, idx)
    out_boxes = torch.where(out_mask[..., None], out_boxes, 0.0)
    out_labels = torch.where(out_mask, out_labels, 0)
    return {"img": img, "gt_bboxes": out_boxes, "gt_labels": out_labels,
            "mask_gt": out_mask}


def device_augment(batch: Dict[str, torch.Tensor], generator: torch.Generator, imgsz: int,
                   mosaic_p: float = 1.0, scale: float = 0.5, translate: float = 0.1,
                   fliplr: float = 0.5, flipud: float = 0.0, hsv_h: float = 0.015,
                   hsv_s: float = 0.7, hsv_v: float = 0.4,
                   max_out: int = 0) -> Dict[str, torch.Tensor]:
    """JAX's one-call `device_augment` (`ops/device_augment.py:58`):
    `augment_draws` from `generator` (in place of JAX's key), then
    `apply_augment` (K3 on the card)."""
    draws = augment_draws(batch["img"].shape[0], imgsz, generator, mosaic_p, scale, translate,
                          fliplr, flipud, hsv_h, hsv_s, hsv_v)
    return apply_augment(batch, draws, imgsz, max_out)
