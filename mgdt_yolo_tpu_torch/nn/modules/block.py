"""Blocks of the flagship graph (NCHW), the counterparts of
`mgdt_yolo_tpu/nn/modules/block.py`: the CSP/SPPF backbone blocks, the
MSPA-C2f attention block, the GD neck modules, the DyDCNv2 wrapper and the
segmentation head's `Proto`.

Submodules carry the flax names (`cv1`, `m_0`, `convs_3`, `attention.fc1`,
...) so the JAX variables load one to one. Where the JAX package computes in
float32 inside a bf16 model (softmaxes, GRN, resampling) this port does too.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.common import (adaptive_avg_pool2d, h_sigmoid, interpolate_bilinear,
                           max_pool2d_same)
from ...ops.cuda_deform import deform_conv
from ...ops.deform import check_semantics
from .conv import Conv


def dfl_decode(box: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution Focal Loss integral decode.

    box: (..., 4 * reg_max) side-major (side, bin) logits. Returns (..., 4)
    expected ltrb distances, in float32.
    """
    probs = torch.softmax(box.reshape(*box.shape[:-1], 4, reg_max).float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=box.device)
    return probs @ proj


class Bottleneck(nn.Module):
    """Residual bottleneck: two 3x3 convs at full width, plus x when
    `shortcut` and the widths allow."""

    def __init__(self, c1: int, c2: int, shortcut: bool):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3)
        self.cv2 = Conv(c2, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with progressive splits."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        c = c2 // 2
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(c, c, shortcut))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class SPPF(nn.Module):
    """Fast spatial pyramid pooling: three chained k-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * 4, c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        y1 = max_pool2d_same(y, self.k)
        y2 = max_pool2d_same(y1, self.k)
        y3 = max_pool2d_same(y2, self.k)
        return self.cv2(torch.cat([y, y1, y2, y3], dim=1))


class Proto(nn.Module):
    """The segmentation head's mask prototypes: Conv 3x3, a 2x2 stride-2
    transposed conv with bias, Conv 3x3, Conv 1x1 to `c2` prototypes.
    flax's `ConvTranspose` (no kernel transpose, 'SAME') correlates where
    torch's convolves, so its (kh, kw, in, out) kernel is torch's (in, out,
    kh, kw) with both spatial axes flipped (`weights.translate`)."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class SPRModule(nn.Module):
    """Dual-pool squeeze attention: global and 2x2 average descriptors,
    flattened channel-major, then a 1x1 reduce/expand and a sigmoid gate."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Conv2d(5 * channels, channels // reduction, 1, bias=True)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=True)

    def forward(self, x=None, pools=None):
        """x (b, c, h, w), or pools = ((b, c) global, (b, c, 2, 2) quadrant)
        averages computed by the caller. Returns (b, c) gates."""
        if pools is None:
            p1 = x.mean(dim=(2, 3))
            p2 = adaptive_avg_pool2d(x, 2)
        else:
            p1, p2 = pools
        b, c = p1.shape
        y = torch.cat([p1, p2.reshape(b, 4 * c)], dim=1)[:, :, None, None]
        y = self.fc2(F.relu(self.fc1(y)))
        return torch.sigmoid(y).reshape(b, c)


class MSPA_C2f(nn.Module):
    """Multi-Scale Pyramid Attention C2f.

    Channel groups 0..scale-2 get 1x1 convs with progressive summation, the
    last group runs `n` bottlenecks keeping every intermediate, a 1x1 fuses
    them, and one shared SPR attention gives per-group weights that are
    softmaxed across groups (in float32) to reweight the fused features.
    """

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 scale: int = 4):
        super().__init__()
        self.nums, self.n = scale, n
        inw = c1 // scale
        self.outw = c2 // scale
        for i in range(scale - 1):
            self.add_module(f"convs_{i}", Conv(inw, inw, 1))
        for j in range(n):
            self.add_module(f"bottleneck_{j}", Bottleneck(inw, inw, shortcut))
        self.add_module(f"convs_{scale - 1}", Conv((scale - 1 + n) * inw, c2, 1))
        self.attention = SPRModule(self.outw)

    def forward(self, x):
        nums, outw = self.nums, self.outw
        spx = x.chunk(nums, dim=1)
        outs, sp = [], None
        for i in range(nums):
            sp = spx[i] if i == 0 else sp + spx[i]
            if i != nums - 1:
                sp = getattr(self, f"convs_{i}")(sp)
                outs.append(sp)
            else:
                for j in range(self.n):
                    sp = getattr(self, f"bottleneck_{j}")(sp)
                    outs.append(sp)
        fused = getattr(self, f"convs_{nums - 1}")(torch.cat(outs, dim=1))
        b, _, h, w = fused.shape
        feats = fused.reshape(b, nums, outw, h, w)
        if h % 2 == 0 and w % 2 == 0:
            p1 = feats.mean(dim=(3, 4)).reshape(b * nums, outw)
            quad = feats.reshape(b, nums, outw, 2, h // 2, 2, w // 2)
            p2 = quad.mean(dim=(4, 6)).reshape(b * nums, outw, 2, 2)
            weights = self.attention(pools=(p1, p2))
        else:
            weights = self.attention(feats.reshape(b * nums, outw, h, w))
        weights = torch.softmax(weights.reshape(b, nums, outw).float(), dim=1)
        out = feats * weights.to(fused.dtype)[..., None, None]
        return out.reshape(b, nums * outw, h, w)


class GRN(nn.Module):
    """Global response normalisation over NHWC input, in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        xf = x.float()
        gx = torch.sqrt((xf ** 2).sum(dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma.float() * (xf * nx) + self.beta.float() + xf).to(x.dtype)


class ConvNeXtV2_Block(nn.Module):
    """ConvNeXtV2 residual block: depthwise 7x7, LayerNorm (eps 1e-6),
    pointwise MLP with GELU and GRN.

    GELU follows the JAX package: the exact erf form in float32, the tanh
    form in bfloat16.
    """

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, bias=True)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)  # NHWC for the norm and MLP
        y = self.pwconv1(self.norm(y))
        y = F.gelu(y, approximate="tanh" if y.dtype == torch.bfloat16 else "none")
        y = self.pwconv2(self.grn(y))
        return x + y.permute(0, 3, 1, 2)


class SimFusion_4in(nn.Module):
    """Align four pyramid levels [P2, P3, P4, P5] to the third one's size
    (average pool down, bilinear up) and concatenate."""

    def forward(self, xs):
        x_l, x_m, x_s, x_n = xs
        hw = x_s.shape[2:]
        return torch.cat([adaptive_avg_pool2d(x_l, hw), adaptive_avg_pool2d(x_m, hw),
                          x_s, interpolate_bilinear(x_n, hw)], dim=1)


class SimFusion_3in(nn.Module):
    """Align three levels to the middle one's size, embed each with a 1x1
    conv where its width differs, concatenate and fuse."""

    def __init__(self, in_channels, c2: int):
        super().__init__()
        for i, c in enumerate(in_channels):
            if c != c2:
                self.add_module(f"cv{i + 1}", Conv(c, c2, act="relu"))
        self.cv_fuse = Conv(3 * c2, c2, act="relu")

    def _embed(self, i, x):
        m = getattr(self, f"cv{i + 1}", None)
        return x if m is None else m(x)

    def forward(self, xs):
        hw = xs[1].shape[2:]
        x0 = self._embed(0, adaptive_avg_pool2d(xs[0], hw))
        x1 = self._embed(1, xs[1])
        x2 = self._embed(2, interpolate_bilinear(xs[2], hw))
        return self.cv_fuse(torch.cat([x0, x1, x2], dim=1))


class IFM(nn.Module):
    """Information fusion: Conv -> ConvNeXtV2 blocks -> Conv to sum(ouc)."""

    def __init__(self, c1: int, ouc, embed_dim_p: int = 96, fuse_block_num: int = 3):
        super().__init__()
        self.conv_in = Conv(c1, embed_dim_p)
        self.blocks = fuse_block_num
        for i in range(fuse_block_num):
            self.add_module(f"block_{i}", ConvNeXtV2_Block(embed_dim_p))
        self.conv_out = Conv(embed_dim_p, sum(ouc))

    def forward(self, x):
        y = self.conv_in(x)
        for i in range(self.blocks):
            y = getattr(self, f"block_{i}")(y)
        return self.conv_out(y)


class InjectionMultiSum_Auto_pool(nn.Module):
    """Inject a slice of the global IFM context into a local map:
    local * gate + global_embed, size-matched by pool or bilinear upsample.

    The pool branch skips h_sigmoid on the gate, as the reference does.
    """

    def __init__(self, c1: int, oup: int, global_inp, flag: int):
        super().__init__()
        self.global_inp = tuple(global_inp)
        self.flag = flag
        cg = self.global_inp[flag]
        self.local_embedding = Conv(c1, oup, 1, act=False)
        self.global_act = Conv(cg, oup, 1, act=False)
        self.global_embedding = Conv(cg, oup, 1, act=False)

    def forward(self, xs):
        x_l, x_g = xs
        h, w = x_l.shape[2:]
        g = x_g.split(list(self.global_inp), dim=1)[self.flag]
        local_feat = self.local_embedding(x_l)
        global_act = self.global_act(g)
        global_feat = self.global_embedding(g)
        if h < x_g.shape[2]:  # pool branch, gate not activated
            sig_act = adaptive_avg_pool2d(global_act, (h, w))
            global_feat = adaptive_avg_pool2d(global_feat, (h, w))
        else:
            sig_act = interpolate_bilinear(h_sigmoid(global_act), (h, w))
            global_feat = interpolate_bilinear(global_feat, (h, w))
        return local_feat * sig_act + global_feat


class DyDCNv2(nn.Module):
    """Modulated deformable conv (no bias) + GroupNorm(16); offsets and mask
    come from the caller. `semantics` is the model's deform pin. The DCN is
    `ops.cuda_deform.deform_conv`: K1 forward, K2 backward on the card, the
    weight cast to x's type as the JAX module casts it."""

    def __init__(self, c1: int, c2: int, semantics: str = "windowed"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, c1, c2))  # HWIO
        self.gn = nn.GroupNorm(16, c2, eps=1e-5)
        self.semantics = check_semantics(semantics)

    def forward(self, x, offset, mask):
        """x (b, c1, h, w), offset (b, 18, h, w), mask (b, 9, h, w) -> NCHW."""
        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()
        y = deform_conv(nhwc(x), nhwc(offset), nhwc(mask), self.weight, self.semantics)
        return self.gn(y.permute(0, 3, 1, 2))
