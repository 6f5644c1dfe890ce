"""Batched class-offset NMS with fixed-size output, the counterpart of
`mgdt_yolo_tpu/ops/nms.py` (`nms_single_fixpoint` and `_blocked_keep`).

Greedy NMS as a fixpoint: a candidate survives iff no higher-scoring
survivor of its class overlaps it above the IoU threshold. Candidates are
the top `pre_topk` scores, score-sorted, so "higher" is "lower index". The
batch dimension is written out where the JAX package uses `vmap`; the
fixpoint runs until no image changes (at most 128 sweeps), which gives each
image the result of its own loop because a fixpoint is stable.

Top-k ties: scores are sigmoids of bf16 logits, so exact ties are common.
`lax.top_k` puts the lower index first; `torch.topk` promises no order on
CUDA, so candidates are taken from a stable descending sort instead.
"""
from __future__ import annotations

import torch

from .boxes import xywh2xyxy

MAX_WH = 7680.0  # class-offset magnitude
MAX_SWEEPS = 128


def _topk_stable(v: torch.Tensor, k: int):
    """Top-k along the last dim, ties broken by the lower index."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _candidates(boxes, scores, conf_thres, pre_topk, multi_label):
    """Per image: confidence-thresholded top-k over (anchor, class) pairs
    (multi_label) or anchors' best class, and the class-offset boxes that
    keep overlaps of different classes from suppressing each other.
    boxes (B, A, 4), scores (B, A, nc). Returns (cand_boxes, conf, cls,
    valid, offset_boxes, anchor_idx, k)."""
    B, A, nc = scores.shape
    neg = torch.tensor(-1.0, dtype=scores.dtype, device=scores.device)
    if multi_label and nc > 1:
        flat = scores.reshape(B, A * nc)
        k = min(pre_topk, A * nc)
        conf, idx = _topk_stable(torch.where(flat > conf_thres, flat, neg), k)
        anchor_idx = idx // nc
        cls = (idx % nc).to(scores.dtype)
    else:
        conf_all = scores.amax(dim=-1)
        cls_all = scores.argmax(dim=-1).to(scores.dtype)
        k = min(pre_topk, A)
        conf, anchor_idx = _topk_stable(
            torch.where(conf_all > conf_thres, conf_all, neg), k)
        cls = torch.gather(cls_all, 1, anchor_idx)
    cand_boxes = torch.gather(boxes, 1, anchor_idx[..., None].expand(-1, -1, 4))
    valid = conf > 0.0
    return (cand_boxes, conf, cls, valid, cand_boxes + (cls * MAX_WH)[..., None],
            anchor_idx, k)


def _pairwise_inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, Na, Nb) xyxy intersection areas."""
    iw = torch.clamp(torch.minimum(a[:, :, None, 2], b[:, None, :, 2]) -
                     torch.maximum(a[:, :, None, 0], b[:, None, :, 0]), min=0)
    ih = torch.clamp(torch.minimum(a[:, :, None, 3], b[:, None, :, 3]) -
                     torch.maximum(a[:, :, None, 1], b[:, None, :, 1]), min=0)
    return iw * ih


def _fixpoint(valid: torch.Tensor, overlap: torch.Tensor) -> torch.Tensor:
    """keep <- valid & ~any(overlap & keep), from keep = valid, until no
    image changes or MAX_SWEEPS sweeps. valid (B, n), overlap (B, n, n)."""
    keep = valid
    for _ in range(MAX_SWEEPS):
        new = valid & ~(overlap & keep[:, None, :]).any(dim=2)
        changed = bool((new != keep).any())
        keep = new
        if not changed:
            break
    return keep


def _blocked_keep(ob, valid, iou_thres: float, block: int, max_det: int):
    """The greedy keep mask computed block by block in score order: each
    block is suppressed by a buffer of the top S = max(512, max_det) keepers
    so far, then resolved by its own fixpoint. Same output as the monolith
    (see the JAX package's `_blocked_keep` for the argument)."""
    B, k, _ = ob.shape
    S = max(512, max_det)
    dev = ob.device
    areas = (ob[..., 2] - ob[..., 0]) * (ob[..., 3] - ob[..., 1])
    # one extra slot takes the writes the JAX scatter drops
    buf_boxes = torch.zeros(B, S + 1, 4, dtype=ob.dtype, device=dev)
    buf_areas = torch.zeros(B, S + 1, dtype=ob.dtype, device=dev)
    buf_valid = torch.zeros(B, S + 1, dtype=torch.bool, device=dev)
    buf_count = torch.zeros(B, dtype=torch.long, device=dev)
    keeps = []
    for s in range(0, k, block):
        e = min(s + block, k)
        nb = e - s
        ob_i, ar_i = ob[:, s:e], areas[:, s:e]
        inter = _pairwise_inter(ob_i, buf_boxes[:, :S])
        iou_b = inter / (ar_i[:, :, None] + buf_areas[:, None, :S] - inter + 1e-7)
        supp = ((iou_b > iou_thres) & buf_valid[:, None, :S]).any(dim=2)
        inter = _pairwise_inter(ob_i, ob_i)
        iou_i = inter / (ar_i[:, :, None] + ar_i[:, None, :] - inter + 1e-7)
        lower = torch.ones(nb, nb, dtype=torch.bool, device=dev).tril(-1)
        keep_i = _fixpoint(valid[:, s:e] & ~supp, (iou_i > iou_thres) & lower)
        keeps.append(keep_i)
        pos = buf_count[:, None] + torch.cumsum(keep_i.long(), dim=1) - 1
        pos = torch.where(keep_i, pos, S).clamp(max=S)
        buf_boxes.scatter_(1, pos[..., None].expand(-1, -1, 4), ob_i)
        buf_areas.scatter_(1, pos, ar_i)
        buf_valid.scatter_(1, pos, torch.ones_like(keep_i))
        buf_count = buf_count + keep_i.sum(dim=1)
    return torch.cat(keeps, dim=1)


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, multi_label: bool = False,
                        max_det: int = 300, pre_topk: int = 1024,
                        return_idx: bool = False, block: int = 256):
    """Batched NMS over the eval-path head output.

    prediction: (B, 4 + nc, A) xywh boxes then class scores. `block` > 0
    resolves candidate pools larger than it block by block (same result).
    Returns det (B, max_det, 6) [x1, y1, x2, y2, conf, cls] zero-padded and
    counts (B,) int32, plus the source anchor of each row (B, max_det)
    int32, -1 for padding, when return_idx.
    """
    pred = prediction.transpose(1, 2)  # (B, A, 4+nc)
    cand_boxes, conf, cls, valid, ob, anchor_idx, k = _candidates(
        xywh2xyxy(pred[..., :4]), pred[..., 4:], conf_thres, pre_topk, multi_label)
    if block and k > block:
        keep = _blocked_keep(ob, valid, iou_thres, block, max_det)
    else:
        areas = (ob[..., 2] - ob[..., 0]) * (ob[..., 3] - ob[..., 1])
        inter = _pairwise_inter(ob, ob)
        iou = inter / (areas[:, :, None] + areas[:, None, :] - inter + 1e-7)
        lower = torch.ones(k, k, dtype=torch.bool, device=ob.device).tril(-1)
        keep = _fixpoint(valid, (iou > iou_thres) & lower)

    neg = torch.tensor(-1.0, dtype=conf.dtype, device=conf.device)
    top_conf, top_idx = _topk_stable(torch.where(keep, conf, neg), min(max_det, k))
    ok = top_conf > 0.0
    det = torch.cat([torch.gather(cand_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
                     torch.gather(conf, 1, top_idx)[..., None],
                     torch.gather(cls, 1, top_idx)[..., None]], dim=-1)
    det = torch.where(ok[..., None], det, torch.zeros((), dtype=det.dtype,
                                                      device=det.device))
    kept = torch.where(ok, torch.gather(anchor_idx, 1, top_idx), -1).to(torch.int32)
    if k < max_det:  # fewer candidates than output rows: pad
        B = det.shape[0]
        det = torch.cat([det, det.new_zeros(B, max_det - k, 6)], dim=1)
        kept = torch.cat([kept, kept.new_full((B, max_det - k), -1)], dim=1)
    counts = ok.sum(dim=1).to(torch.int32)
    return (det, counts, kept) if return_idx else (det, counts)
