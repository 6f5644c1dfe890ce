"""Transformer layers and the RT-DETR head (token-major (b, L, d) inside,
NCHW maps outside), the counterparts of
`mgdt_yolo_tpu/nn/modules/transformer.py`: multi-head attention, the AIFI
encoder, the C3TR transformer block, the MLP, multi-scale deformable
attention, the deformable decoder layer and `RTDETRDecoder`.

Submodules carry the flax names (`ma.q_proj`, `norm1`, `layers_0`,
`decoder_layer_3.cross_attn.sampling_offsets`, ...). The numerics follow
JAX's where they differ from torch's defaults: LayerNorm's eps is flax's
1e-6, GELU is exact, attention logits and softmaxes are float32 (rounded
there and cast back, in a float64 model too, as JAX's
`preferred_element_type=float32` does), and the anchors are built in
float32. No hand kernel is on this path: the deformable sampling is
`torch.nn.functional.grid_sample`, the plain counterpart of JAX's gathers.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nms import _topk_stable
from .conv import BN, Conv

LN_EPS = 1e-6  # flax's LayerNorm epsilon


def layer_norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class MultiHeadAttention(nn.Module):
    """Batch-first multi-head attention with biased q/k/v/out projections;
    `attn_mask` is boolean, True where attention is blocked."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.d, self.h = embed_dim, num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v, attn_mask: Optional[torch.Tensor] = None):
        b, lq, _ = q.shape
        lk = k.shape[1]
        h, hd = self.h, self.d // self.h
        qh = self.q_proj(q).view(b, lq, h, hd).transpose(1, 2)
        kh = self.k_proj(k).view(b, lk, h, hd).transpose(1, 2)
        vh = self.v_proj(v).view(b, lk, h, hd).transpose(1, 2)
        logits = (qh @ kh.transpose(-1, -2)).float() / math.sqrt(hd)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, float("-inf"))
        w = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = (w @ vh).float().to(q.dtype)  # (b, h, lq, hd), rounded as JAX's
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, self.d))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: attention with `pos` added to queries and
    keys, then an exact-GELU feed-forward of width cm."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiHeadAttention(c1, num_heads)
        self.norm1 = layer_norm(c1)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm2 = layer_norm(c1)

    def forward(self, src, pos: Optional[torch.Tensor] = None):
        q = src if pos is None else src + pos
        src = self.norm1(src + self.ma(q, q, src))
        return self.norm2(src + self.fc2(F.gelu(self.fc1(src))))


class AIFI(nn.Module):
    """RT-DETR's single-scale encoder over an NCHW map, with the 2D sincos
    position embedding as the reference builds it: rows W-major, added to
    H-major tokens (so transposed on a non-square map; kept)."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.enc = TransformerEncoderLayer(c1, cm, num_heads)

    def forward(self, x):
        b, c, h, w = x.shape
        pos = torch.from_numpy(sincos_embed(w, h, c)).to(device=x.device, dtype=x.dtype)
        out = self.enc(x.flatten(2).transpose(1, 2), pos)
        return out.transpose(1, 2).reshape(b, c, h, w)


def sincos_embed(w: int, h: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """(1, w * h, dim) float32, JAX's `AIFI._sincos_embed` in numpy: the
    same operations, so the same bits."""
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32),
                                 indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.flatten()[:, None] @ omega[None]
    out_h = grid_h.flatten()[:, None] @ omega[None]
    emb = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)
    return np.ascontiguousarray(emb[None], dtype=np.float32)


class TransformerLayer(nn.Module):
    """Norm-free ViT layer: bias-free q/k/v, attention plus x, then the
    bias-free fc2(fc1(.)) plus that."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = MultiHeadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        x = self.ma(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """A `Conv` to c2 where the widths differ, a learned linear position
    term added to the tokens, then `num_layers` `TransformerLayer`s."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        self.conv = Conv(c1, c2) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.n = num_layers
        for i in range(num_layers):
            self.add_module(f"tr_{i}", TransformerLayer(c2, num_heads))

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)
        p = p + self.linear(p)
        for i in range(self.n):
            p = getattr(self, f"tr_{i}")(p)
        return p.transpose(1, 2).reshape(b, c, h, w)


class MLP(nn.Module):
    """`num_layers` Linear layers (`layers_i`), ReLU between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.n = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", nn.Linear(
                input_dim if i == 0 else hidden_dim,
                output_dim if i == num_layers - 1 else hidden_dim))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


def deform_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """The reference's sampling-offset bias: a ring of unit directions per
    head, scaled by the point's index (JAX's `_deform_bias_init`)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: each head samples `n_points`
    points on each of `n_levels` maps around its query's reference box
    (xywh, normalised) or point, bilinearly (`grid_sample`: align_corners
    False, zeros outside the map, locations `loc * 2 - 1`), weighted by a
    float32 softmax over levels and points."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d, self.L, self.h, self.P = d_model, n_levels, n_heads, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)
        with torch.no_grad():  # JAX's initializers (a model's init replaces them)
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(deform_bias(n_heads, n_levels, n_points))
            self.attention_weights.weight.zero_()

    def forward(self, query, refer_bbox, value, value_shapes: Sequence[Tuple[int, int]],
                value_mask: Optional[torch.Tensor] = None):
        """query (b, lq, d), refer_bbox (b, lq, 1, 2 or 4), value (b, lv, d)
        flattened level by level (H-major), value_shapes [(h, w)]."""
        b, lq = query.shape[:2]
        lv = value.shape[1]
        d, h, L, P = self.d, self.h, self.L, self.P
        hd = d // h
        value = self.value_proj(value)
        if value_mask is not None:
            value = value.masked_fill(~value_mask[..., None], 0.0)
        off = self.sampling_offsets(query).view(b, lq, h, L, P, 2)
        attw = torch.softmax(self.attention_weights(query).view(b, lq, h, L * P).float(), -1)
        attw = attw.to(query.dtype).view(b, lq, h, L, P)
        if refer_bbox.shape[-1] == 2:
            norm = torch.tensor([[w, hh] for hh, w in value_shapes], dtype=query.dtype,
                                device=query.device)
            loc = refer_bbox[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
        else:
            ref = refer_bbox[:, :, None, :, None, :]
            loc = ref[..., :2] + off / P * ref[..., 2:] * 0.5
        grids = (loc * 2 - 1).permute(0, 2, 1, 3, 4, 5).reshape(b * h, lq, L, P, 2)
        value = value.view(b, lv, h, hd)
        samples, start = [], 0
        for li, (H, W) in enumerate(value_shapes):
            v = value[:, start:start + H * W].permute(0, 2, 3, 1).reshape(b * h, hd, H, W)
            samples.append(F.grid_sample(v, grids[:, :, li], mode="bilinear",
                                         padding_mode="zeros", align_corners=False))
            start += H * W
        s = torch.stack(samples, dim=3)  # (b * h, hd, lq, L, P)
        w = attw.permute(0, 2, 1, 3, 4).reshape(b * h, 1, lq, L, P)
        out = (s * w).sum(dim=(3, 4)).view(b, h, hd, lq)
        return self.output_proj(out.permute(0, 3, 1, 2).reshape(b, lq, d))


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention (the denoising mask), deformable cross-attention over
    the multi-scale features, a ReLU feed-forward; post-norm."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024,
                 n_levels: int = 4, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads)
        self.norm1 = layer_norm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = layer_norm(d_model)

    def forward(self, embed, refer_bbox, feats, shapes, attn_mask=None, query_pos=None):
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, attn_mask))
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm2(embed + self.cross_attn(q, refer_bbox[:, :, None, :], feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


def cls_bias(nc: int, prior: float = 0.01) -> float:
    """The class heads' prior bias, as JAX's `_cls_bias`."""
    return float(-math.log((1 - prior) / prior) / 80 * nc)


class RTDETRDecoder(nn.Module):
    """RT-DETR's head over `len(ch)` NCHW maps: 1x1 projections to `hd`
    with BatchNorm, an encoder head that scores every token (features at
    anchors outside the margin zeroed), the top `nq` (stable, as
    `lax.top_k`) as queries, then `ndl` deformable decoder layers with
    iterative box refinement.

    `forward(xs, dn=None)` returns (dec_bboxes, dec_scores, enc_bboxes,
    enc_scores, dn_meta) as JAX's head does: in `eval()` mode the
    `eval_idx` layer's boxes (1, b, nq, 4) and sigmoid scores (1, b, nq,
    nc); in `train()` mode every layer's boxes and logits (ndl, b, nq', ...)
    with the embeddings and reference boxes of the selection detached, each
    layer after the first refined from the previous layer's undetached
    boxes. `dn` ({gt_labels, gt_bboxes_norm, mask_gt, and noise or a
    generator}, train only) prepends the contrastive denoising group
    (`vit.utils.ops.get_cdn_group`): nq' = D + nq, dn_meta describes it."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (512, 1024, 2048), hd: int = 256,
                 nq: int = 300, ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024,
                 eval_idx: int = -1, num_denoising: int = 100, label_noise_ratio: float = 0.5,
                 box_noise_scale: float = 1.0):
        super().__init__()
        self.nc, self.ch, self.hd, self.nq, self.ndl = nc, tuple(ch), hd, nq, ndl
        self.eval_idx = eval_idx if eval_idx >= 0 else ndl + eval_idx
        self.num_denoising = num_denoising
        self.label_noise_ratio, self.box_noise_scale = label_noise_ratio, box_noise_scale
        for i, c in enumerate(self.ch):
            self.add_module(f"input_proj_{i}", nn.Conv2d(c, hd, 1, bias=False))
            self.add_module(f"input_proj_bn_{i}", BN(hd))
        self.enc_output_dense = nn.Linear(hd, hd)
        self.enc_output_norm = layer_norm(hd)
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.denoising_class_embed = nn.Parameter(torch.zeros(nc, hd))
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        for i in range(ndl):
            self.add_module(f"decoder_layer_{i}", DeformableTransformerDecoderLayer(
                hd, nh, d_ffn, len(self.ch), ndp))
            self.add_module(f"dec_score_head_{i}", nn.Linear(hd, nc))
            self.add_module(f"dec_bbox_head_{i}", MLP(hd, hd, 4, 3))
        with torch.no_grad():  # JAX's class prior (a model's init replaces it)
            for i in range(ndl):
                getattr(self, f"dec_score_head_{i}").bias.fill_(cls_bias(nc))
            self.enc_score_head.bias.fill_(cls_bias(nc))

    @torch.no_grad()
    def fuse(self) -> bool:
        """Fold each `input_proj_bn_i` into `input_proj_i`; False if done."""
        from ..fuse import fold
        done = False
        for i in range(len(self.ch)):
            bn = getattr(self, f"input_proj_bn_{i}")
            if isinstance(bn, BN):
                setattr(self, f"input_proj_{i}", fold(getattr(self, f"input_proj_{i}"), bn.bn))
                setattr(self, f"input_proj_bn_{i}", nn.Identity())
                done = True
        return done

    def forward(self, xs, dn=None):
        feats, shapes = [], []
        for i, x in enumerate(xs):
            y = getattr(self, f"input_proj_bn_{i}")(getattr(self, f"input_proj_{i}")(x))
            shapes.append(tuple(y.shape[2:]))
            feats.append(y.flatten(2).transpose(1, 2))
        feats = torch.cat(feats, dim=1)
        anchors, valid = generate_anchors(shapes, feats.dtype, feats.device)
        features = self.enc_output_norm(self.enc_output_dense(
            torch.where(valid, feats, torch.zeros((), dtype=feats.dtype, device=feats.device))))
        enc_scores_all = self.enc_score_head(features)
        enc_bboxes_all = self.enc_bbox_head(features) + anchors

        train = self.training
        nq = min(self.nq, feats.shape[1])  # fewer tokens than queries at small sizes
        dn_embed = dn_bbox = attn_mask = dn_meta = None
        if train and dn is not None:
            from ...vit.utils.ops import get_cdn_group
            dn_embed, dn_bbox, attn_mask, dn_meta = get_cdn_group(
                dn["gt_labels"], dn["gt_bboxes_norm"], dn["mask_gt"], self.nc, nq,
                self.denoising_class_embed.to(features.dtype), self.num_denoising,
                self.label_noise_ratio, self.box_noise_scale, noise=dn.get("noise"),
                generator=dn.get("generator"))

        _, topk_ind = _topk_stable(enc_scores_all.amax(-1).float(), nq)
        pick = topk_ind[..., None]
        refer_bbox = torch.gather(enc_bboxes_all, 1, pick.expand(-1, -1, 4))
        enc_bboxes = torch.sigmoid(refer_bbox)
        enc_scores = torch.gather(enc_scores_all, 1, pick.expand(-1, -1, self.nc))
        embed = torch.gather(features, 1, pick.expand(-1, -1, self.hd))
        if train:
            embed, refer_bbox = embed.detach(), refer_bbox.detach()
        if dn_bbox is not None:
            refer_bbox = torch.cat([dn_bbox.to(refer_bbox.dtype), refer_bbox], dim=1)
        if dn_embed is not None:
            embed = torch.cat([dn_embed.to(embed.dtype), embed], dim=1)

        output, ref = embed, torch.sigmoid(refer_bbox)
        dec_bboxes, dec_cls, last_refined = [], [], None
        for i in range(self.ndl):
            output = getattr(self, f"decoder_layer_{i}")(output, ref, feats, shapes, attn_mask,
                                                        self.query_pos_head(ref))
            bbox_head = getattr(self, f"dec_bbox_head_{i}")
            delta = bbox_head(output)
            refined = torch.sigmoid(delta + inverse_sigmoid(ref))
            if train:
                dec_cls.append(getattr(self, f"dec_score_head_{i}")(output))
                dec_bboxes.append(refined if i == 0 else
                                  torch.sigmoid(delta + inverse_sigmoid(last_refined)))
            elif i == self.eval_idx:
                dec_cls.append(getattr(self, f"dec_score_head_{i}")(output))
                dec_bboxes.append(refined)
                break
            last_refined = refined
            ref = refined.detach() if train else refined
        dec_bboxes, dec_cls = torch.stack(dec_bboxes), torch.stack(dec_cls)
        if not train:
            dec_cls = torch.sigmoid(dec_cls)
        return dec_bboxes, dec_cls, enc_bboxes, enc_scores, dn_meta


def generate_anchors(shapes, dtype, device, grid_size: float = 0.05, eps: float = 1e-2):
    """(anchors (1, N, 4) in logit space, inf outside the margin; valid
    (1, N, 1)) over the levels' (h, w), computed in float32 as JAX does,
    dividing each cell's (x, y) by (h, w): the reference's quirk, kept (it
    shows on non-square maps)."""
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        gxy = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([h, w], dtype=torch.float32,
                                                              device=device)
        wh = torch.full_like(gxy, grid_size * (2.0 ** i))
        anchors.append(torch.cat([gxy, wh], -1).reshape(1, h * w, 4))
    anchors = torch.cat(anchors, dim=1)
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.log(anchors / (1 - anchors))
    anchors = torch.where(valid, anchors, torch.tensor(float("inf"), device=device))
    return anchors.to(dtype), valid
