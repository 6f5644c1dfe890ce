"""Eval-time Conv+BN folding, the counterpart of `mgdt_yolo_tpu/nn/fuse.py`.

w' = w * scale / sqrt(var + eps);  b' = bias - mean * scale / sqrt(var + eps)
becomes the conv's weight and a real conv bias, and the norm is dropped
(the JAX package keeps an identity BatchNorm instead; the output is the
same up to rounding). The fold is computed in float32.
"""
from __future__ import annotations

import torch.nn as nn

from .modules.conv import BN, Conv


def fuse_conv(m: Conv) -> bool:
    """Fold one Conv's BatchNorm into its conv; False if already folded."""
    if not isinstance(m.norm, BN):
        return False
    bn, conv = m.norm.bn, m.conv
    g = bn.weight.detach().float() / (bn.running_var.float() + bn.eps).sqrt()
    w = conv.weight.detach()
    fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                      conv.stride, conv.padding, dilation=conv.dilation,
                      groups=conv.groups, bias=True).to(device=w.device, dtype=w.dtype)
    fused.weight.data = (w.float() * g.reshape(-1, 1, 1, 1)).to(w.dtype)
    fused.bias.data = (bn.bias.detach().float() - bn.running_mean.float() * g).to(w.dtype)
    m.conv, m.norm = fused, nn.Identity()
    return True


def fuse_conv_bn(model: nn.Module) -> int:
    """Fold every Conv+BN pair of a model in place; returns how many."""
    return sum(fuse_conv(m) for m in model.modules() if isinstance(m, Conv))
