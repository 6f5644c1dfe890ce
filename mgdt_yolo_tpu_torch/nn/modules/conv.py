"""Convolution primitives (NCHW), the counterparts of
`mgdt_yolo_tpu/nn/modules/conv.py`.

Submodule names follow the JAX package's flax names (`conv`, `norm.bn`), so
a flax path maps to a state-dict key one to one (see `weights.py`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.common import interpolate_bilinear, upsample_nearest

BN_EPS = 1e-3        # the reference's BatchNorm eps
BN_MOMENTUM = 0.03   # torch convention (flax momentum 0.97)


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same'-shape padding for odd kernels."""
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

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p=None, g: int = 1,
                 d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.norm = BN(c2)
        self.default_act = act is True
        self.act = get_act(act)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


def set_default_act(module: nn.Module, act) -> nn.Module:
    """Give every `Conv` of `module` built with `act=True` the activation
    `act` (a config's `activation:`, "nn.ReLU()" in YOLOv6's), as the
    reference's `Conv.default_act` swap and JAX's trace-time default do,
    here for this module alone."""
    for m in module.modules():
        if isinstance(m, Conv) and m.default_act:
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
    """The bare transposed conv of a graph row `nn.ConvTranspose2d [c2, k, s,
    p]` (YOLOv6's upsampling): with bias, no BatchNorm and no activation,
    under the flax name `conv_transpose` as JAX's `ConvTranspose(bn=False,
    act=False)` nests it (its flipped kernel: `weights.translate`)."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.conv_transpose = nn.ConvTranspose2d(c1, c2, k, s, p, bias=True)

    def forward(self, x):
        return self.conv_transpose(x)


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
