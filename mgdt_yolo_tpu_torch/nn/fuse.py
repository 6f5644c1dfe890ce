"""Eval-time Conv+BN folding, the counterpart of `mgdt_yolo_tpu/nn/fuse.py`.

w' = w * scale / sqrt(var + eps);  b' = bias - mean * scale / sqrt(var + eps)
becomes the conv's weight and a real conv bias, and the norm is dropped
(the JAX package keeps an identity BatchNorm instead; the output is the
same up to rounding). The fold is computed in float32.

Beyond JAX's folds (every `Conv`, and `Conv2`'s 1x1 branch, which JAX
scales by the gain and the port adds to the centre tap), the port also
folds a `ConvTranspose`'s norm into its transposed conv, merges the
branches of `RepConv` and `RepVGGBlock` into one conv, and folds
`RTDETRDecoder`'s `input_proj_bn_i` into `input_proj_i`: a fused forward
equals the unfused one up to rounding.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .modules.conv import BN, Conv, Conv2, ConvTranspose, RepConv, RepVGGBlock, _center_tap
from .modules.transformer import RTDETRDecoder


def _gain(bn: nn.BatchNorm2d) -> torch.Tensor:
    return bn.weight.detach().float() / (bn.running_var.float() + bn.eps).sqrt()


def fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """A new conv with bias computing bn(conv(x)) in eval mode."""
    g = _gain(bn)
    w = conv.weight.detach()
    fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                      conv.stride, conv.padding, dilation=conv.dilation,
                      groups=conv.groups, bias=True).to(device=w.device, dtype=w.dtype)
    b = conv.bias.detach().float() * g if conv.bias is not None else 0.0
    fused.weight.data = (w.float() * g.reshape(-1, 1, 1, 1)).to(w.dtype)
    fused.bias.data = (b + bn.bias.detach().float() - bn.running_mean.float() * g).to(w.dtype)
    return fused


def fuse_conv(m: Conv) -> bool:
    """Fold one Conv's BatchNorm into its conv; False if already folded."""
    if not isinstance(m.norm, BN):
        return False
    m.conv, m.norm = fold(m.conv, m.norm.bn), nn.Identity()
    return True


@torch.no_grad()
def fuse_conv2(m: Conv2) -> bool:
    """Add Conv2's 1x1 into the centre tap of its k x k conv (both 'same'
    padded, as every config builds them), then fold the norm."""
    if not isinstance(m.norm, BN):
        return False
    conv, cv2 = m.conv, m.cv2
    k = conv.kernel_size
    centred = conv.padding == (k[0] // 2, k[1] // 2) and cv2.padding == (0, 0) and \
        conv.dilation == (1, 1) and conv.stride == cv2.stride
    if not centred:
        raise ValueError(f"Conv2 with padding {conv.padding}/{cv2.padding} and dilation "
                         f"{conv.dilation} has no centre tap to fold its 1x1 into")
    conv.weight.copy_((conv.weight.float() + _center_tap(cv2.weight.float(), k))
                      .to(conv.weight.dtype))
    m.conv, m.norm, m.cv2 = fold(conv, m.norm.bn), nn.Identity(), None
    return True


@torch.no_grad()
def fuse_conv_transpose(m: ConvTranspose) -> bool:
    """Fold a ConvTranspose's norm into its transposed conv (its weight is
    (in, out, kh, kw): the gain scales dim 1)."""
    if not isinstance(m.norm, BN):
        return False
    ct, g = m.conv_transpose, _gain(m.norm.bn)
    bn = m.norm.bn
    fused = nn.ConvTranspose2d(ct.in_channels, ct.out_channels, ct.kernel_size, ct.stride,
                               ct.padding, ct.output_padding, ct.groups, bias=True,
                               dilation=ct.dilation).to(device=ct.weight.device,
                                                        dtype=ct.weight.dtype)
    b = ct.bias.float() * g if ct.bias is not None else 0.0
    fused.weight.copy_((ct.weight.float() * g.reshape(1, -1, 1, 1)).to(ct.weight.dtype))
    fused.bias.copy_((b + bn.bias.float() - bn.running_mean.float() * g).to(ct.weight.dtype))
    m.conv_transpose, m.norm = fused, nn.Identity()
    return True


def fuse_conv_bn(model: nn.Module) -> int:
    """Fold every Conv+BN pair of a model in place (and the folds above);
    returns how many norms were folded or branches merged."""
    mods = list(model.modules())
    n = sum(fuse_conv2(m) for m in mods if isinstance(m, Conv2))
    n += sum(fuse_conv_transpose(m) for m in mods if isinstance(m, ConvTranspose))
    n += sum(fuse_conv(m) for m in mods if isinstance(m, Conv))
    # after the Convs: RepConv / RepVGGBlock merge folded branches, the
    # RT-DETR decoder folds its input projections' norms
    n += sum(m.fuse() for m in mods if isinstance(m, (RepConv, RepVGGBlock, RTDETRDecoder)))
    return n
