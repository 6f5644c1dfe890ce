"""Blocks of the model graphs (NCHW), the counterparts of
`mgdt_yolo_tpu/nn/modules/block.py`: the CSP/SPP backbone blocks (C1, C2,
C2f, C3, C3x, C3TR, C3Ghost, BottleneckCSP, RepC3), the ghost bottleneck,
RT-DETR's HGNetV2 stem and block, the MSPA-C2f attention block, the GD
neck modules, the DyDCNv2 wrapper and the segmentation head's `Proto`.

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
from ...ops import cuda_deform  # noqa: F401  (registers the mgdt::deform_fwd operator)
from ...ops.deform import check_semantics, modulated_deform_conv2d
from .conv import BN, Conv, DWConv, GhostConv, LightConv, RepConv, get_act
from .transformer import TransformerBlock


def dfl_decode(box: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution Focal Loss integral decode.

    box: (..., 4 * reg_max) side-major (side, bin) logits. Returns (..., 4)
    expected ltrb distances, in float32.
    """
    probs = torch.softmax(box.reshape(*box.shape[:-1], 4, reg_max).float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=box.device)
    return probs @ proj


class Bottleneck(nn.Module):
    """Residual bottleneck: a k[0] conv to c2 * e channels, a k[1] conv
    (groups `g`) back to c2, plus x when `shortcut` and the widths allow.
    The CSP blocks take e = 1; a graph row `Bottleneck [c2, shortcut, g, k,
    e]` (YOLOv3) the reference's e = 0.5."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2(nn.Module):
    """CSP bottleneck with 2 convs: the first half of cv1's output through
    n bottlenecks, concatenated with the second half, then cv2."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(c, c, shortcut, g, e=1.0))
        self.cv2 = Conv(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        for i in range(self.n):
            a = getattr(self, f"m_{i}")(a)
        return self.cv2(torch.cat([a, b], dim=1))


class C2f(nn.Module):
    """CSP bottleneck with progressive splits (hidden width int(c2 * e),
    bottleneck groups `g`)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(c, c, shortcut, g, e=1.0))
        self.cv2 = Conv((2 + n) * c, c2, 1)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class C3(nn.Module):
    """CSP bottleneck with 3 convs: cv1's branch through n bottlenecks
    (groups `g`, kernels `k`), concatenated with cv2's, then cv3."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k=((1, 1), (3, 3))):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(c_, c_, shortcut, g, k=k, e=1.0))
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m_{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C1(nn.Module):
    """CSP bottleneck with 1 conv: cv1, then n 3x3 Convs, plus cv1's output."""

    def __init__(self, c1: int, c2: int, n: int = 1):
        super().__init__()
        self.n = n
        self.cv1 = Conv(c1, c2, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Conv(c2, c2, 3))

    def forward(self, x):
        y = z = self.cv1(x)
        for i in range(self.n):
            z = getattr(self, f"m_{i}")(z)
        return z + y


class C3x(C3):
    """C3 whose bottlenecks take the cross 1x3 / 3x1 convolutions."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, k=((1, 3), (3, 1)))


class C3TR(nn.Module):
    """C3 whose inner branch is a `TransformerBlock` (4 heads, n layers);
    `shortcut` and `g` are taken and unused, as in JAX."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.m = TransformerBlock(c_, c_, 4, n)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: GhostConv to c2 / 2, a linear depthwise k x k where
    the stride is 2, a linear GhostConv to c2; plus the shortcut (x where
    the widths match at stride 1, nothing where they do not, a linear
    depthwise then 1x1 Conv at stride 2)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.s, self.add = s, c1 == c2
        self.ghost1 = GhostConv(c1, c_, 1, 1)
        if s == 2:
            self.dw = DWConv(c_, c_, k, s, act=False)
        self.ghost2 = GhostConv(c_, c2, 1, 1, act=False)
        if s == 2:
            self.sc_dw = DWConv(c1, c1, k, s, act=False)
            self.sc_pw = Conv(c1, c2, 1, 1, act=False)

    def forward(self, x):
        y = self.ghost1(x)
        if self.s == 2:
            y = self.dw(y)
        y = self.ghost2(y)
        if self.s == 2:
            return y + self.sc_pw(self.sc_dw(x))
        return y + x if self.add else y


class C3Ghost(C3):
    """C3 whose bottlenecks are `GhostBottleneck`s (`g` taken and unused,
    as in JAX)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        for i in range(n):
            self.add_module(f"m_{i}", GhostBottleneck(c_, c_))


class RepC3(nn.Module):
    """RT-DETR's neck block: cv1 through n `RepConv`s plus cv2 (then cv3
    where the hidden width is not c2; the graph builds e = 1, so never)."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", RepConv(c_, c_))
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else None

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m_{i}")(a)
        y = a + self.cv2(x)
        return self.cv3(y) if self.cv3 is not None else y


class BottleneckCSP(nn.Module):
    """The original CSP bottleneck: cv1 through n bottlenecks then the bare
    1x1 `cv3`, beside the bare 1x1 `cv2` of x, one BatchNorm over both and
    the default activation, then cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = Conv(c1, c_, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(c_, c_, shortcut, g, e=1.0))
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.norm = BN(2 * c_)
        self.default_act = True
        self.act = get_act(True)
        self.cv4 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m_{i}")(y1)
        y = self.norm(torch.cat([self.cv3(y1), self.cv2(x)], dim=1))
        return self.cv4(self.act(y))


class HGStem(nn.Module):
    """HGNetV2's stem (stride 4, ReLU): stem1 3x3/2, padded by one row and
    column at the bottom and right; a 2x2 max pool of that beside the
    stem2a/stem2b 2x2 convs (each after such a pad), cropped to stem2b's
    size; concatenated, stem3 3x3/2, stem4 1x1. JAX pools with a one-sided
    -inf pad and crops; the crop keeps only windows inside the map, so the
    pool here is the plain 2x2 window at stride 1."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act="relu")
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = Conv(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = Conv(cm, c2, 1, 1, act="relu")

    def forward(self, x):
        y = F.pad(self.stem1(x), (0, 1, 0, 1))
        y2 = self.stem2b(F.pad(self.stem2a(y), (0, 1, 0, 1)))
        y1 = F.max_pool2d(y, 2, 1)[..., :y2.shape[2], :y2.shape[3]]
        return self.stem4(self.stem3(torch.cat([y1, y2], dim=1)))


class HGBlock(nn.Module):
    """HGNetV2's block: n chained k x k Convs (`LightConv`s with
    `lightconv`) of width cm, every output and x concatenated, squeezed to
    c2 / 2 (`sc`) and excited to c2 (`ec`), plus x with `shortcut` where
    c1 == c2; ReLU throughout."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False, act="relu"):
        super().__init__()
        block = LightConv if lightconv else Conv
        self.n = n
        for i in range(n):
            self.add_module(f"m_{i}", block(c1 if i == 0 else cm, cm, k=k, act=act))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act=act)
        self.ec = Conv(c2 // 2, c2, 1, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, dim=1)))
        return y + x if self.add else y


class SPP(nn.Module):
    """Spatial pyramid pooling: cv1, its max pools at each of `k` (stride
    1, same size), concatenated, then cv2."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * (len(self.k) + 1), c2, 1)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [max_pool2d_same(y, k) for k in self.k], dim=1))


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

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5, scale: int = 4):
        super().__init__()
        self.nums, self.n = scale, n
        inw = c1 // scale   # `e` is taken and unused, as in JAX
        self.outw = c2 // scale
        for i in range(scale - 1):
            self.add_module(f"convs_{i}", Conv(inw, inw, 1))
        for j in range(n):
            self.add_module(f"bottleneck_{j}", Bottleneck(inw, inw, shortcut, g, e=1.0))
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
    """Modulated deformable conv + GroupNorm(16), or + a bias where
    `with_norm` is False; offsets and mask come from the caller, and
    `semantics` is the model's deform pin (JAX `nn/modules/block.py:597-611`).
    The DCN is `ops.deform.modulated_deform_conv2d`, routed by shape as
    JAX's `auto` dispatch (`mgdt_yolo_tpu/ops/deform.py:151-153`): at stride
    1 K1 forward and K2 backward on the card (the bias added inside K1),
    the weight cast to x's type as the JAX module casts it; at stride 2
    (which no Pallas kernel takes, `ops/pallas_deform.py:155-166`) the plain
    exact DCN on either device."""

    def __init__(self, c1: int, c2: int, stride: int = 1, with_norm: bool = True,
                 semantics: str = "windowed"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, c1, c2))  # HWIO
        self.stride, self.with_norm = stride, with_norm
        if with_norm:
            self.gn = nn.GroupNorm(16, c2, eps=1e-5)
        else:
            self.bias = nn.Parameter(torch.zeros(c2))
        self.semantics = check_semantics(semantics)

    def forward(self, x, offset, mask):
        """x (b, c1, h, w), offset (b, 18, ho, wo), mask (b, 9, ho, wo) -> NCHW."""
        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()
        y = modulated_deform_conv2d(nhwc(x), nhwc(offset), nhwc(mask), self.weight,
                                    None if self.with_norm else self.bias, stride=self.stride,
                                    padding=1, semantics=self.semantics).permute(0, 3, 1, 2)
        return self.gn(y) if self.with_norm else y
