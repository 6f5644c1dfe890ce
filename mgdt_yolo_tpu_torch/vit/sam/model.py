"""SAM: the composite model and the `SAM` facade (prompted prediction and
point-grid automatic mask generation), the counterparts of
`mgdt_yolo_tpu/vit/sam/model.py`.

`SAM(model="sam_b", img_size=1024, dtype=torch.float32, seed=0,
weights=None, device=None)` builds the ViT-B/L/H SAM (`SAM_ARCHS`) from the
port's seeded init on `device` (CUDA by default), or loads a reference
`.pt` (`SAM("sam_b.pt")`, through `utils/torch_import.load_torch_pt` and
`weights.load_sam_state_dict`). `predict(image, points, labels)` runs
prompted prediction on an (h, w, 3) BGR uint8 image, `generate(image)` (or
calling the facade) the single-crop automatic mask generation.

Where JAX calls cv2: the image's resize is `data/augment.resize_linear`
(cv2's uint8 INTER_LINEAR); the masks' float32 resizes are
`resize_linear_f32` below, cv2 5's float32 INTER_LINEAR (coordinates in
double, fractions in float32, each pass `fma(b - a, f, a)`), on the
masks' device.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...data.augment import resize_linear
from ...device import parse_device
from .modules import (Attention, ImageEncoderViT, LayerNorm2d, MaskDecoder,
                      PositionEmbeddingRandom, PromptEncoder)

LOGGER = logging.getLogger(__name__)

SAM_ARCHS = {
    # encoder width, depth, heads, global-attention blocks
    "sam_b": (768, 12, 12, (2, 5, 8, 11)),
    "sam_l": (1024, 24, 16, (5, 11, 17, 23)),
    "sam_h": (1280, 32, 16, (7, 15, 23, 31)),
}
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class Sam(nn.Module):
    """Image encoder, prompt encoder and mask decoder (prompt and decoder
    width 256, a 16x16 patch)."""

    def __init__(self, arch: str = "sam_b", img_size: int = 1024):
        super().__init__()
        dim, depth, heads, gidx = SAM_ARCHS[arch]
        self.arch, self.img_size = arch, img_size
        self.image_encoder = ImageEncoderViT(img_size=img_size, embed_dim=dim, depth=depth,
                                             num_heads=heads, global_attn_indexes=gidx)
        emb = img_size // 16
        self.prompt_encoder = PromptEncoder(256, (emb, emb), (img_size, img_size))
        self.mask_decoder = MaskDecoder(256)

    @staticmethod
    def preprocess(x: torch.Tensor) -> torch.Tensor:
        """Normalised by the float32 pixel mean and std."""
        mean = torch.tensor(PIXEL_MEAN, device=x.device).view(-1, 1, 1)
        std = torch.tensor(PIXEL_STD, device=x.device).view(-1, 1, 1)
        return (x - mean) / std

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) raw 0-255 RGB -> (B, 256, S / 16, S / 16)."""
        dtype = self.image_encoder.pos_embed.dtype
        return self.image_encoder(self.preprocess(x.float()).to(dtype))

    def decode(self, image_embeddings, points, labels, multimask_output: bool = True):
        """Point prompts (B, N, 2) in `img_size` pixels with labels (B, N)
        -> (masks (B, 3, S / 4, S / 4) float32 logits, iou (B, 3))."""
        sparse, dense = self.prompt_encoder(points=points, labels=labels)
        return self.mask_decoder(image_embeddings, self.prompt_encoder.get_dense_pe(), sparse,
                                 dense, multimask_output)

    def forward(self, x, points, labels):
        return self.decode(self.encode_image(x), points, labels)


@torch.no_grad()
def init_sam(module: nn.Module, seed: int = 0) -> nn.Module:
    """The port's seeded init, by one `torch.Generator` over the modules in
    order, with the scheme of JAX's `fast_init_sam`: linear and conv
    weights uniform in +-1/sqrt(fan_in) (the input channels times the taps;
    a transposed conv's input channels are its weight's first axis), norm
    weights 1, embeddings, tokens and the absolute position table
    N(0, 0.02^2), the Fourier matrix N(0, 1), biases and the
    relative-position tables 0."""
    g = torch.Generator().manual_seed(seed)

    def uniform(w, fan_in):
        bound = fan_in ** -0.5
        w.copy_(torch.rand(w.shape, generator=g) * (2 * bound) - bound)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            uniform(w, w[:, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel())
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.02)
        elif isinstance(m, PositionEmbeddingRandom):
            t = m.positional_encoding_gaussian_matrix
            t.copy_(torch.randn(t.shape, generator=g))
        elif isinstance(m, ImageEncoderViT):
            m.pos_embed.copy_(torch.randn(m.pos_embed.shape, generator=g) * 0.02)
        elif isinstance(m, Attention) and m.use_rel_pos:
            m.rel_pos_h.zero_()
            m.rel_pos_w.zero_()
    return module


def _linear_taps(src: int, dst: int):
    """cv2 5's float32 INTER_LINEAR taps along one axis: the source index
    from a double coordinate, its fraction rounded to float32; out of range
    the edge pixel with fraction 0."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    edge = (s < 0) | (s >= src - 1)
    frac[edge] = 0.0
    s = np.clip(s, 0, src - 1)
    return s, np.minimum(s + 1, src - 1), frac


def _fma(d: torch.Tensor, f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """float32 `fma(d, f, a)`: the product exact in float64, one rounding
    to float32 after the sum (a second, float64, rounding first)."""
    return (d.double() * f.double() + a.double()).float()


def resize_linear_f32(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)` for float32
    maps (..., H, W), on their device; `size` is (h, w). cv2 5 takes this
    path at a down-ratio of 2 too (its INTER_AREA shortcut is for 8-bit
    images only)."""
    oh, ow = size
    H, W = x.shape[-2:]
    if (H, W) == (oh, ow):
        return x.clone()
    dev = x.device
    x0, x1, fx = (torch.from_numpy(a).to(dev) for a in _linear_taps(W, ow))
    y0, y1, fy = (torch.from_numpy(a).to(dev) for a in _linear_taps(H, oh))
    a = x[..., x0]
    h = _fma(x[..., x1] - a, fx, a)
    top = h[..., y0, :]
    return _fma(h[..., y1, :] - top, fy[:, None], top)


class SAM:
    """See the module's text."""

    def __init__(self, model: str = "sam_b", img_size: int = 1024, dtype=torch.float32,
                 seed: int = 0, weights=None, device=None):
        name = str(model)
        ckpt = None
        if name.endswith(".pt"):
            if not Path(name).is_file():
                raise FileNotFoundError(f"SAM checkpoint {name!r} not found")
            ckpt = name
        arch = Path(name).stem.replace("-", "_")
        if arch not in SAM_ARCHS:
            raise ValueError(f"unknown SAM variant {model!r}; choose from {list(SAM_ARCHS)}")
        self.arch, self.img_size, self.dtype = arch, img_size, dtype
        self.device = parse_device(device)
        self.module = init_sam(Sam(arch, img_size), seed)
        for w in (ckpt, weights):
            if w is not None:
                self.load(w)
        self.module.to(self.device, dtype).eval()
        n = sum(p.numel() for p in self.module.parameters())
        LOGGER.info(f"SAM {arch}: {n:,} parameters @ {img_size}px")

    def load(self, weights) -> Dict:
        """Merge a reference SAM checkpoint (a `.pt` path, or a flat state
        dict of arrays) into the model, non-strictly; returns the report."""
        from ...utils.torch_import import load_torch_pt
        from .weights import load_sam_state_dict
        sd = weights
        if isinstance(sd, (str, bytes)) or hasattr(sd, "__fspath__"):
            sd, _ = load_torch_pt(str(sd))
        return load_sam_state_dict(self.module, sd)

    # ---- the model's steps ------------------------------------------------
    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.module.encode_image(x)

    @torch.no_grad()
    def decode(self, emb: torch.Tensor, points: np.ndarray, labels: np.ndarray):
        """Prompts in `img_size` pixels -> (masks, iou) on the device."""
        pts = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        lab = torch.as_tensor(np.asarray(labels, np.int64), device=self.device)
        return self.module.decode(emb, pts, lab)

    # ---- prompted prediction ---------------------------------------------
    def predict(self, image: np.ndarray, points=None, labels=None, multimask: bool = True):
        """image (h, w, 3) BGR uint8; points (B, N, 2) in its pixels (the
        centre by default), labels (B, N) (foreground by default). Returns
        (masks (B, 3, h, w) float32 logits, iou (B, 3)) as numpy. As in
        JAX, `multimask` is accepted and the three multimask outputs are
        always returned."""
        x, scale, (h0, w0) = self._prep(image)
        if points is None:
            points = np.array([[[w0 / 2, h0 / 2]]], np.float32)
        if labels is None:
            labels = np.ones(np.shape(points)[:2], np.int32)
        pts = np.asarray(points, np.float32) * scale
        masks, iou = self.decode(self.encode(x), pts, labels)
        return (self._postprocess_masks(masks, scale, (h0, w0)).cpu().numpy(),
                iou.float().cpu().numpy())

    def __call__(self, image: np.ndarray, points_per_side: int = 8,
                 pred_iou_thresh: float = 0.7):
        return self.generate(image, points_per_side, pred_iou_thresh)

    # ---- automatic mask generation -----------------------------------------
    @torch.no_grad()
    def generate(self, image: np.ndarray, points_per_side: int = 8,
                 pred_iou_thresh: float = 0.7, mask_threshold: float = 0.0,
                 stability_score_thresh: float = 0.0,
                 stability_score_offset: float = 1.0) -> List[Dict]:
        """JAX's single-crop point-grid generation: one decode of the grid's
        points (3 masks each), kept where the predicted IoU passes
        `pred_iou_thresh` and the stability score `stability_score_thresh`;
        each kept mask at the image's size, binarised, dropped under 16
        pixels; then, in order of predicted IoU, dropped where its IoU with
        a mask kept before passes 0.7. Returns dicts of `segmentation`
        ((h, w) bool), `area`, `bbox` (x, y, w, h), `predicted_iou`,
        `stability_score`."""
        from .amg import build_point_grid
        x, scale, (h0, w0) = self._prep(image)
        emb = self.encode(x)
        pts = (build_point_grid(points_per_side) * np.array([w0, h0], np.float32))[:, None, :]
        n = pts.shape[0]
        masks, ious = self.decode(emb, (pts * scale).astype(np.float32), np.ones((n, 1)))
        masks = masks.reshape(-1, *masks.shape[2:])
        ious = ious.reshape(-1).cpu().numpy()
        high = (masks > mask_threshold + stability_score_offset).sum((-1, -2)).cpu().numpy()
        low = (masks > mask_threshold - stability_score_offset).sum((-1, -2)).cpu().numpy()
        stability = high / np.maximum(low, 1)
        keep = np.flatnonzero((ious > pred_iou_thresh) & (stability >= stability_score_thresh))
        if not keep.size:
            return []
        full = self._postprocess_masks(masks[torch.from_numpy(keep).to(masks.device)][None],
                                       scale, (h0, w0))[0] > mask_threshold
        area = full.sum((-1, -2)).cpu().numpy()
        big = area >= 16
        keep, full, area = keep[big], full[torch.from_numpy(big).to(full.device)], area[big]
        if not keep.size:
            return []
        order = np.argsort(-ious[keep], kind="stable")
        keep, area = keep[order], area[order]
        full = full[torch.from_numpy(order).to(full.device)]
        flat = full.reshape(len(keep), -1).float()
        inter = (flat @ flat.T).round().long().cpu().numpy()
        cols, rows = full.any(-2).cpu().numpy(), full.any(-1).cpu().numpy()
        kept: List[int] = []
        for i in range(len(keep)):
            if not any((area[i] + area[j] - inter[i, j]) and
                       inter[i, j] / (area[i] + area[j] - inter[i, j]) > 0.7 for j in kept):
                kept.append(i)
        segs = full[torch.tensor(kept, device=full.device)].cpu().numpy()
        out = []
        for seg, i in zip(segs, kept):
            xs, ys = np.flatnonzero(cols[i]), np.flatnonzero(rows[i])
            out.append({"segmentation": seg, "area": int(area[i]),
                        "bbox": [int(xs[0]), int(ys[0]), int(xs[-1] - xs[0]),
                                 int(ys[-1] - ys[0])],
                        "predicted_iou": float(ious[keep[i]]),
                        "stability_score": float(stability[keep[i]])})
        return out

    # ---- helpers -----------------------------------------------------------
    def _prep(self, image: np.ndarray):
        """(1, 3, S, S) float32 RGB canvas on the device: the image resized
        so its long side is `img_size` (cv2's uint8 INTER_LINEAR), padded
        with the pixel mean (0 once normalised); (canvas, scale, (h, w))."""
        h0, w0 = image.shape[:2]
        scale = self.img_size / max(h0, w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        resized = resize_linear(np.ascontiguousarray(image[..., ::-1]), (nw, nh))
        S = self.img_size
        canvas = torch.tensor(PIXEL_MEAN, device=self.device).view(1, 3, 1, 1).repeat(1, 1, S, S)
        canvas[0, :, :nh, :nw] = torch.from_numpy(resized).to(self.device).permute(2, 0, 1)
        return canvas, scale, (h0, w0)

    def _postprocess_masks(self, masks, scale: float, orig_hw) -> torch.Tensor:
        """(B, N, h, w) low-res logits -> (B, N, H0, W0) float32 at the
        image's size, on the masks' device: upsampled to `img_size`, the
        padding cropped, resized to the image."""
        h0, w0 = orig_hw
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        masks = torch.as_tensor(masks).float()
        up = resize_linear_f32(masks, (self.img_size, self.img_size))
        return resize_linear_f32(up[..., :nh, :nw], (h0, w0))
