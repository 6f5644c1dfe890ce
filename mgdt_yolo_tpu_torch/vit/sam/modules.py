"""SAM's modules: the windowed ViT image encoder, the prompt encoder and the
two-way mask decoder, the counterparts of `mgdt_yolo_tpu/vit/sam/modules.py`.

The module tree and parameter names are the reference's (`image_encoder.
blocks.0.attn.qkv.weight`, `mask_decoder.output_upscaling.0.weight`, ...),
so a reference SAM state dict loads by name (`weights.py`). The encoder
keeps its tokens channels-last (B, H, W, C) between the patch embedding and
the neck, as the reference and JAX do; images, the image embedding and the
dense prompt are (B, C, H, W). Attention logits and softmaxes are float32
in float32 and bf16, as JAX's `preferred_element_type=jnp.float32` makes
them (float64 in a float64 model, which JAX would round to float32: the
port's float64 serves as a reference on the CPU); `LayerNorm2d` normalises
in float32 (float64) and casts back. Inference only, like the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of a (B, C, H, W) map, eps 1e-6, in
    float32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        u = xf.mean(1, keepdim=True)
        s = (xf - u).pow(2).mean(1, keepdim=True)
        y = (xf - u) / torch.sqrt(s + self.eps)
        return (y * self.weight.to(acc)[:, None, None] + self.bias.to(acc)[:, None, None]
                ).to(x.dtype)


class MLP(nn.Module):
    """`num_layers` Linear layers with ReLU between them (the hypernetworks
    and the IoU head)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k) for n, k in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=nn.GELU):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> ((B * nW, ws, ws, C), (Hp, Wp)), zero-padded at the
    bottom and right to a multiple of the window."""
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    if ph or pw:
        x = nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    """The inverse of `window_partition`, the padding cropped."""
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // (Hp * Wp // ws // ws)
    x = x.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C) relative-position embeddings from a table of
    2 max(q, k) - 1 rows; a table of another length is first resized by
    JAX's recipe (float32 linspace, floor, linear weights), not
    `F.interpolate`'s."""
    max_rel = 2 * max(q_size, k_size) - 1
    n = rel_pos.shape[0]
    if n != max_rel:
        t = torch.linspace(0, n - 1, max_rel, dtype=torch.float32, device=rel_pos.device)
        lo = torch.floor(t).long()
        hi = (lo + 1).clamp(0, n - 1)
        w = (t - lo.float())[:, None]
        rel_pos = rel_pos[lo] * (1 - w) + rel_pos[hi] * w
    q_coords = torch.arange(q_size, dtype=torch.float64)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float64)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


class Attention(nn.Module):
    """Multi-head attention over a (B, H, W, C) grid with the decomposed
    relative-position bias (a row term and a column term of the unscaled
    queries added to the float32 logits)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 use_rel_pos: bool = False, input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * nh, H * W, -1).unbind(0)
        acc = torch.promote_types(q.dtype, torch.float32)
        attn = torch.matmul((q * self.scale).to(acc), k.to(acc).transpose(-2, -1))
        if self.use_rel_pos:
            Rh = get_rel_pos(H, H, self.rel_pos_h).to(acc)
            Rw = get_rel_pos(W, W, self.rel_pos_w).to(acc)
            r_q = q.reshape(B * nh, H, W, -1).to(acc)
            rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
            rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
            a = attn.view(B * nh, H, W, H, W)
            a.add_(rel_h[:, :, :, :, None]).add_(rel_w[:, :, :, None, :])
        attn = attn.softmax(-1).to(v.dtype)
        out = torch.matmul(attn, v).view(B, nh, H, W, -1).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(B, H, W, -1))


class ViTBlock(nn.Module):
    """A pre-norm transformer block (LayerNorm eps 1e-6, exact GELU) whose
    attention runs in windows of `window_size` (0: over the whole grid)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, window_size: int = 0,
                 input_size: Optional[Tuple[int, int]] = None, use_rel_pos: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, use_rel_pos=use_rel_pos,
                              input_size=input_size if window_size == 0
                              else (window_size, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        y = self.norm1(x)
        if self.window_size > 0:
            H, W = y.shape[1:3]
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (H, W))
        x = shortcut + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)  # (B, H, W, C)


class ImageEncoderViT(nn.Module):
    """SAM's image encoder: (B, 3, S, S) normalised pixels -> (B, out_chans,
    S / 16, S / 16). Windowed blocks, global ones at `global_attn_indexes`,
    an absolute position table for the grid at `img_size`, then the neck
    (1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d, no biases)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = ()):
        super().__init__()
        self.img_size = img_size
        gh = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh, gh, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio,
                     window_size=0 if i in global_attn_indexes else window_size,
                     input_size=(gh, gh))
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False), LayerNorm2d(out_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, :x.shape[1], :x.shape[2]]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding of [0, 1] coordinates."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        c = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix.float()
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], -1)


class PromptEncoder(nn.Module):
    """Point and box prompts -> (sparse (B, S, C), dense (B, C, h, w)).
    Points (B, N, 2) are pixels of the `input_image_size` canvas with labels
    (B, N) (1 foreground, 0 background, -1 padding); without boxes a padding
    point (0, 0) of label -1 is appended. Boxes (B, M, 4) xyxy add their two
    corners with `point_embeddings[2]` and `[3]`. No mask prompt: the dense
    prompt is `no_mask_embed` everywhere."""

    def __init__(self, embed_dim: int = 256, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024)):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """(1, C, h, w) encoding of the embedding grid's cell centres."""
        h, w = self.image_embedding_size
        dev = self.no_mask_embed.weight.device
        gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(gy, gx, indexing="ij")
        return self.pe_layer(torch.stack([xx, yy], -1)).permute(2, 0, 1)[None]

    def _norm(self, xy: torch.Tensor) -> torch.Tensor:
        size = torch.tensor([self.input_image_size[1], self.input_image_size[0]],
                            dtype=torch.float32, device=xy.device)
        return (xy.float() + 0.5) / size

    def forward(self, points=None, labels=None, boxes=None):
        parts = []
        B = 1
        if points is not None:
            B = points.shape[0]
            if boxes is None:
                points = torch.cat([points, points.new_zeros(B, 1, 2)], 1)
                labels = torch.cat([labels, -labels.new_ones(B, 1)], 1)
            pe = self.pe_layer(self._norm(points))
            lab = labels[..., None]
            wt = lambda m: m.weight.float()  # noqa: E731
            pe = torch.where(lab == -1, wt(self.not_a_point_embed), pe)
            pe = pe + torch.where(lab == 1, wt(self.point_embeddings[1]),
                                  torch.where(lab == 0, wt(self.point_embeddings[0]),
                                              torch.zeros_like(pe)))
            parts.append(pe)
        if boxes is not None:
            B = boxes.shape[0]
            pe = self.pe_layer(self._norm(boxes.reshape(B, -1, 2, 2)))
            corners = torch.stack([self.point_embeddings[2].weight[0],
                                   self.point_embeddings[3].weight[0]]).float()
            parts.append((pe + corners).reshape(B, -1, self.embed_dim))
        dev = self.no_mask_embed.weight.device
        sparse = torch.cat(parts, 1) if parts else torch.zeros(B, 0, self.embed_dim, device=dev)
        h, w = self.image_embedding_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(B, -1, h, w)
        return sparse.to(self.no_mask_embed.weight.dtype), dense


class TwoWayAttention(nn.Module):
    """Attention with its projections down to `dim / downsample_rate`."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, internal)
        self.k_proj = nn.Linear(dim, internal)
        self.v_proj = nn.Linear(dim, internal)
        self.out_proj = nn.Linear(internal, dim)

    def forward(self, q, k, v):
        B, Lq = q.shape[:2]
        Lk = k.shape[1]
        h = self.num_heads
        qh = self.q_proj(q).view(B, Lq, h, -1).transpose(1, 2)
        kh = self.k_proj(k).view(B, Lk, h, -1).transpose(1, 2)
        vh = self.v_proj(v).view(B, Lk, h, -1).transpose(1, 2)
        acc = torch.promote_types(qh.dtype, torch.float32)
        logits = torch.matmul(qh.to(acc), kh.to(acc).transpose(-2, -1)) / math.sqrt(qh.shape[-1])
        out = torch.matmul(logits.softmax(-1).to(vh.dtype), vh)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, -1))


class TwoWayAttentionBlock(nn.Module):
    """Self-attention of the tokens, tokens to image, a ReLU MLP, image to
    tokens; LayerNorm eps 1e-5 after each."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = TwoWayAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = TwoWayAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = TwoWayAttention(dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


# JAX's name for the block (`vit/sam/modules.py:287`)
TwoWayBlock = TwoWayAttentionBlock


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = TwoWayAttention(embedding_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, C, h, w), image_pe (1, C, h, w), tokens
        (B, N, C) -> (tokens (B, N, C), keys (B, h w, C))."""
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    """Masks and their predicted IoUs from the image embedding and the
    prompts: the IoU and mask tokens through the two-way transformer, the
    image upscaled 4x (two 2x2 stride-2 transposed convs, LayerNorm2d,
    exact GELU), each mask a hypernetwork's dot product with it."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256):
        super().__init__()
        d = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(2, d, 8, 2048)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool = True):
        """-> (masks (B, 3 or 1, 4h, 4w) logits, iou (B, 3 or 1)), float32
        (float64 in a float64 model)."""
        B = sparse_prompt.shape[0]
        n = self.num_mask_tokens
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])[None].expand(B, -1, -1)
        tokens = torch.cat([tokens, sparse_prompt], 1)
        src = image_embeddings.expand(B, -1, -1, -1) + dense_prompt
        hs, src_out = self.transformer(src, image_pe.to(src.dtype), tokens)
        h, w = image_embeddings.shape[2:]
        y = self.output_upscaling(src_out.transpose(1, 2).reshape(B, -1, h, w))
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        acc = torch.promote_types(y.dtype, torch.float32)
        masks = torch.matmul(hyper.to(acc), y.to(acc).flatten(2)).view(B, n, *y.shape[2:])
        iou = self.iou_prediction_head(hs[:, 0]).to(acc)
        if multimask_output:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, :1], iou[:, :1]
