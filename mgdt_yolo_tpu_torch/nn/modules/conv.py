"""Convolution primitives (NCHW), the counterparts of
`mgdt_yolo_tpu/nn/modules/conv.py`.

Submodule names follow the JAX package's flax names (`conv`, `norm.bn`), so
a flax path maps to a state-dict key one to one (see `weights.py`). A
module built with `act=True` takes the model's default activation
(`default_act`, `set_default_act`).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.common import interpolate_bilinear, upsample_nearest

BN_EPS = 1e-3        # the reference's BatchNorm eps
BN_MOMENTUM = 0.03   # torch convention (flax momentum 0.97)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x times its sigmoid (JAX `nn/modules/conv.py:32`)."""
    return x * torch.sigmoid(x)


def torch_conv_init(shape, generator: torch.Generator | None = None) -> torch.Tensor:
    """A float32 HWIO kernel drawn as torch's `nn.Conv2d` default draws one,
    uniform(+-sqrt(1 / fan_in)), fan_in = kh kw Cin (JAX
    `nn/modules/conv.py:67-78`, there from a PRNG key, here from
    `generator`)."""
    bound = math.sqrt(1.0 / (shape[0] * shape[1] * shape[2]))
    return torch.rand(tuple(shape), generator=generator) * (2 * bound) - bound


def autopad(k, p: int | None = None, d: int = 1):
    """'same'-shape padding for odd kernels; a (kh, kw) kernel gets a pad
    per axis (C3x's cross convs)."""
    if isinstance(k, (tuple, list)):
        return tuple(autopad(x, p, d) for x in k)
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


def get_act(act) -> nn.Module:
    """True -> SiLU, False/None -> identity, "silu"/"relu" (also as a YAML
    names it, "nn.ReLU()") -> that one."""
    if act is True:
        return nn.SiLU()
    if act is False or act is None:
        return nn.Identity()
    table = {"silu": nn.SiLU, "relu": nn.ReLU}
    s = str(act).lower().replace("nn.", "").replace("()", "")
    if s not in table:
        raise KeyError(f"activation {act!r} is not ported")
    return table[s]()


class BN(nn.Module):
    """BatchNorm with the reference's eps, under the flax name `bn`.

    In training, the running variance follows flax: it moves toward the
    *biased* batch variance, where `nn.BatchNorm2d` would use the unbiased
    one. Both normalise with the biased variance.
    """

    def __init__(self, c: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        bn = self.bn
        if not self.training:
            return bn(x)
        # the batch norm updates copies (autograd keeps them); torch stores
        # new = (1-m) old + m u, u the unbiased variance over n values, and
        # flax's (1-m) old + m u (n-1)/n is new - m u/n with m u = new - (1-m) old
        mean, var = bn.running_mean.clone(), bn.running_var.clone()
        y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, bn.momentum, bn.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var - (var - (1.0 - bn.momentum) * bn.running_var) / n)
        return y


class Conv(nn.Module):
    """conv2d (no bias; padding `p`, 'same' by default; groups `g`,
    dilation `d`) + BatchNorm + activation (`nn/fuse.py` folds the
    BatchNorm into the conv for serving). `act=True` is the model's default
    activation, SiLU unless the model's config overrides it
    (`set_default_act`)."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p=None, g: int = 1,
                 d: int = 1, act=True):
        super().__init__()
        k = tuple(k) if isinstance(k, (tuple, list)) else k
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.norm = BN(c2)
        self.default_act = act is True
        self.act = get_act(act)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


def set_default_act(module: nn.Module, act) -> nn.Module:
    """Give every module of `module` built with `act=True` (a `Conv`,
    `Conv2`, `RepConv`, a BatchNorm'd `ConvTranspose`, `BottleneckCSP`'s
    own) the activation `act` (a config's `activation:`, "nn.ReLU()" in
    YOLOv6's), as the reference's `Conv.default_act` swap and JAX's
    trace-time default do, here for this module alone."""
    for m in module.modules():
        if getattr(m, "default_act", False):
            m.act = get_act(act)
    return module


class MaxPool2d(nn.Module):
    """torch's `nn.MaxPool2d(k, s, p)` as a graph layer (YOLOv3-tiny)."""

    def __init__(self, k: int, s=None, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = int(k), int(s if s is not None else k), int(p)

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p)


class ZeroPad2d(nn.Module):
    """torch's `nn.ZeroPad2d`, the pad (left, right, top, bottom)."""

    def __init__(self, pad):
        super().__init__()
        self.pad = tuple(int(v) for v in pad)

    def forward(self, x):
        return F.pad(x, self.pad)


class ConvTranspose(nn.Module):
    """Transposed conv (kernel `k`, stride `s`, padding `p`), under the flax
    name `conv_transpose` (its flipped kernel: `weights.translate`), with a
    bias and nothing after it by default: the bare deconv of a graph row
    `nn.ConvTranspose2d [c2, k, s, p]` (YOLOv6's upsampling), JAX's
    `ConvTranspose(bn=False, act=False)`. With `bn` a BatchNorm (`norm`)
    replaces the bias and `act` follows, as a graph row `ConvTranspose`
    builds it (JAX's defaults `bn=True, act=True`); `nn/fuse.py` folds the
    norm."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0, bn: bool = False,
                 act=False):
        super().__init__()
        self.conv_transpose = nn.ConvTranspose2d(c1, c2, k, s, p, bias=not bn)
        self.norm = BN(c2) if bn else nn.Identity()
        self.default_act = act is True
        self.act = get_act(act)

    def forward(self, x):
        return self.act(self.norm(self.conv_transpose(x)))


class DWConvTranspose2d(nn.ConvTranspose2d):
    """Depthwise transposed conv with a bias, groups gcd(c1, c2): torch's
    grouped `conv_transpose2d`. JAX keeps one (k, k, c1, c2 / g) kernel
    directly on the layer (`params.model_i.kernel`), the flipped image of
    this (c1, c2 / g, k, k) weight (`weights.translate`)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p1: int = 0):
        super().__init__(c1, c2, k, s, p1, groups=math.gcd(c1, c2), bias=True)


class Conv2(nn.Module):
    """A k x k conv and a parallel 1x1 conv (both without bias, groups `g`)
    summed under one BatchNorm and activation; `nn/fuse.py` folds the 1x1
    into the centre tap, then the norm."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p=None, g: int = 1,
                 d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.cv2 = nn.Conv2d(c1, c2, 1, s, autopad(1, p, d), dilation=d, groups=g, bias=False)
        self.norm = BN(c2)
        self.default_act = act is True
        self.act = get_act(act)

    def forward(self, x):
        y = self.conv(x)
        if self.cv2 is not None:
            y = y + self.cv2(x)
        return self.act(self.norm(y))


class DWConv(nn.Module):
    """Depthwise conv: a `Conv` (flax name `conv`) with groups gcd(c1, c2);
    RT-DETR's downsamplers take `act=False`."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = Conv(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)

    def forward(self, x):
        return self.conv(x)


class LightConv(nn.Module):
    """A linear 1x1 `Conv` then a depthwise k x k `DWConv` (HGBlock's)."""

    def __init__(self, c1: int, c2: int, k: int = 1, act="relu"):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=act)

    def forward(self, x):
        return self.conv2(self.conv1(x))


def _center_tap(w1: torch.Tensor, k) -> torch.Tensor:
    """A 1x1 kernel (O, I, 1, 1) padded to the centre of a k x k one."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return F.pad(w1, (kw // 2, kw // 2, kh // 2, kh // 2))


class RepConv(nn.Module):
    """A k x k `Conv` and a 1x1 `Conv` (both linear, groups `g`) summed, with
    an identity BatchNorm branch where `bn_identity` and the widths allow,
    then the activation. `fuse()` (after `nn/fuse.py` folds the two Convs'
    norms) merges the branches into `conv1` alone."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, act=True,
                 bn_identity: bool = False):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, p=0, g=g, act=False)
        self.norm_id = BN(c1) if bn_identity and c1 == c2 and s == 1 else None
        self.default_act = act is True
        self.act = get_act(act)

    def forward(self, x):
        y = self.conv1(x)
        if self.conv2 is not None:
            y = y + self.conv2(x)
        if self.norm_id is not None:
            y = y + self.norm_id(x)
        return self.act(y)

    @torch.no_grad()
    def fuse(self) -> bool:
        """Merge the folded branches into `conv1` (a 3x3 conv with bias):
        the 1x1 on its centre tap, the identity norm as a scaled centre
        tap; False if already merged or a branch is not folded yet."""
        return _merge_branches(self, "conv1", "conv2", "norm_id")


class RepVGGBlock(nn.Module):
    """Three branches summed then ReLU: a dense 3x3 `Conv` and a 1x1 `Conv`
    (both linear) and, where c1 == c2 at stride 1, an identity BatchNorm.
    `fuse()` merges them as `RepConv.fuse` does."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1):
        super().__init__()
        if k != 3:
            raise ValueError(f"RepVGGBlock takes k=3, not {k}")
        self.rbr_dense = Conv(c1, c2, 3, s, g=g, act=False)
        self.rbr_1x1 = Conv(c1, c2, 1, s, p=0, g=g, act=False)
        self.rbr_identity = BN(c1) if c1 == c2 and s == 1 else None
        self.act = nn.ReLU()

    def forward(self, x):
        y = self.rbr_dense(x)
        if self.rbr_1x1 is not None:
            y = y + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return self.act(y)

    @torch.no_grad()
    def fuse(self) -> bool:
        return _merge_branches(self, "rbr_dense", "rbr_1x1", "rbr_identity")


def _merge_branches(m: nn.Module, dense: str, one: str, ident: str) -> bool:
    """`RepConv.fuse` for the branch names `dense`, `one` (1x1), `ident`
    (BatchNorm or None) of `m`: each Conv's norm must be folded already."""
    d, o, i = getattr(m, dense), getattr(m, one), getattr(m, ident)
    if o is None or isinstance(d.norm, BN) or isinstance(o.norm, BN):
        return False
    conv = d.conv
    w = conv.weight.float() + _center_tap(o.conv.weight.float(), conv.kernel_size)
    b = conv.bias.float() + o.conv.bias.float()
    if i is not None:
        bn = i.bn
        g = bn.weight.float() / (bn.running_var.float() + bn.eps).sqrt()
        per_group = conv.in_channels // conv.groups
        eye = torch.zeros_like(w)
        kh, kw = conv.kernel_size
        idx = torch.arange(conv.out_channels, device=w.device)
        eye[idx, idx % per_group, kh // 2, kw // 2] = g
        w = w + eye
        b = b + bn.bias.float() - bn.running_mean.float() * g
    conv.weight.copy_(w.to(conv.weight.dtype))
    conv.bias.copy_(b.to(conv.bias.dtype))
    setattr(m, one, None)
    setattr(m, ident, None)
    return True


class Focus(nn.Module):
    """Space to channels (the 2x2 pixels of each cell, in JAX's order: even
    rows and columns, odd rows, odd columns, both odd) then a `Conv`."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, p=None, g: int = 1, act=True):
        super().__init__()
        self.conv = Conv(4 * c1, c2, k, s, p, g, act=act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1))


class GhostConv(nn.Module):
    """Ghost conv: `cv1` to half the width, a cheap 5x5 depthwise `cv2` of
    it, the two concatenated."""

    def __init__(self, c1: int, c2: int, k=1, s: int = 1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class ChannelAttention(nn.Module):
    """SE-style channel gate: x times the sigmoid of a biased 1x1 conv `fc`
    of its spatial mean (JAX `nn/modules/conv.py:365-375`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """Spatial gate: x times the sigmoid of a k x k conv `cv1` (no bias) over
    its channel mean and max (JAX `nn/modules/conv.py:378-390`)."""

    def __init__(self, k: int = 7):
        super().__init__()
        self.cv1 = nn.Conv2d(2, 1, k, padding=k // 2, bias=False)

    def forward(self, x):
        stat = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.cv1(stat))


class CBAM(nn.Module):
    """Channel then spatial attention (JAX `nn/modules/conv.py:393-401`);
    no YAML uses it."""

    def __init__(self, c1: int, k: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(k)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class Concat(nn.Module):
    """Concatenate a list of NCHW maps on the channel axis (the YAML's dim 1
    is NCHW's channel axis, the one used here)."""

    def forward(self, xs):
        return torch.cat(list(xs), dim=1)


class Upsample(nn.Module):
    """`nn.Upsample` with an integer scale: 'nearest' repeats values,
    'bilinear' resizes with align_corners=False (`ops/common.py`)."""

    def __init__(self, scale: int = 2, mode: str = "nearest"):
        super().__init__()
        if mode not in ("nearest", "bilinear"):
            raise KeyError(f"upsample mode {mode!r} is not ported")
        self.scale, self.mode = int(scale), mode

    def forward(self, x):
        if self.mode == "nearest":
            return upsample_nearest(x, self.scale)
        h, w = x.shape[2:]
        return interpolate_bilinear(x, (h * self.scale, w * self.scale))
