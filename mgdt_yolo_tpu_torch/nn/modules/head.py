"""The heads (NCHW), YOLOv8's `Detect`, TOOD, `Segment` and `Pose`, and the
eval-path decode, the counterparts of `mgdt_yolo_tpu/nn/modules/head.py`."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.boxes import dist2bbox, make_anchors
from .block import DyDCNv2, Proto, dfl_decode
from .conv import Conv, get_act


def _head_conv(c1: int, c2: int, k: int) -> nn.Conv2d:
    """Plain conv2d with bias and 'same' padding."""
    return nn.Conv2d(c1, c2, k, padding=k // 2, bias=True)


class Conv_GN(nn.Module):
    """conv (no bias; stride `s`) + GroupNorm(16, eps 1e-5) + the activation
    `act` (SiLU by default), as JAX's `nn/modules/head.py:32-49`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, padding=k // 2, bias=False)
        self.gn = nn.GroupNorm(16, c2, eps=1e-5)
        self.act = get_act(act)

    def forward(self, x):
        return self.act(self.gn(self.conv(x)))


class TaskDecomposition(nn.Module):
    """Layer attention over the stacked tower features.

    The (b, stacked) attention scales the (stacked, fc, fc) blocks of the
    1x1 reduction kernel, which is then applied per sample. The reduction
    bias is loaded and never applied, as in the reference.
    """

    def __init__(self, feat_channels: int, stacked_convs: int, la_down_rate: int):
        super().__init__()
        cin = feat_channels * stacked_convs
        self.fc, self.stacked = feat_channels, stacked_convs
        self.la_conv1 = _head_conv(cin, cin // la_down_rate, 1)
        self.la_conv2 = _head_conv(cin // la_down_rate, stacked_convs, 1)
        self.reduction_weight = nn.Parameter(torch.zeros(1, 1, cin, feat_channels))
        self.reduction_bias = nn.Parameter(torch.zeros(feat_channels))  # unused

    def forward(self, feat, avg_feat):
        b, cin, h, w = feat.shape
        wgt = torch.sigmoid(self.la_conv2(F.relu(self.la_conv1(avg_feat))))
        k = self.reduction_weight.reshape(self.stacked, self.fc, self.fc)
        conv_w = (wgt.reshape(b, self.stacked, 1, 1) * k).reshape(b, cin, self.fc)
        out = torch.bmm(conv_w.transpose(1, 2), feat.reshape(b, cin, h * w))
        return F.relu(out.reshape(b, self.fc, h, w))


def decode_detections(feats, strides, nc: int, reg_max: int) -> torch.Tensor:
    """Eval-path decode of NCHW raw maps: (B, 4+nc, A) with xywh in input
    pixels, then sigmoid class scores (taken in float32)."""
    flat = torch.cat([f.flatten(2) for f in feats], dim=2).transpose(1, 2)
    box, cls = flat[..., :reg_max * 4], flat[..., reg_max * 4:]
    anchors, stride_t = make_anchors([f.shape[2:] for f in feats], strides, 0.5,
                                     device=flat.device)
    dist = dfl_decode(box, reg_max) if reg_max > 1 else box
    dbox = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
    out = torch.cat([dbox, torch.sigmoid(cls.float())], dim=-1)
    return out.transpose(1, 2)


class Detect(nn.Module):
    """YOLOv8's decoupled head, one box and one class branch per level, at
    the fork's reg_max 4. Layers `cv2_{i}_{j}` (box) and `cv3_{i}_{j}`
    (class) carry the flax names: two Conv+BN+SiLU, then a conv with bias."""

    def __init__(self, nc: int, ch, strides, reg_max: int = 4):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2, c3 = max(16, ch[0] // 4, reg_max * 4), max(ch[0], nc)
        for i, c in enumerate(ch):
            for name, hidden, out in (("cv2", c2, 4 * reg_max), ("cv3", c3, nc)):
                self.add_module(f"{name}_{i}_0", Conv(c, hidden, 3))
                self.add_module(f"{name}_{i}_1", Conv(hidden, hidden, 3))
                self.add_module(f"{name}_{i}_2", _head_conv(hidden, out, 1))

    def forward(self, xs):
        """Returns (decoded (B, 4+nc, A), [raw map (B, no, h, w)] per level);
        in training (None, [raw map]), without the decode."""
        feats = []
        for i, x in enumerate(xs):
            branches = []
            for name in ("cv2", "cv3"):
                y = x
                for j in range(3):
                    y = getattr(self, f"{name}_{i}_{j}")(y)
                branches.append(y)
            feats.append(torch.cat(branches, dim=1))
        if self.training:
            return None, feats
        return decode_detections(feats, self.strides, self.nc, self.reg_max), feats


class TOODHead(nn.Module):
    """Task-aligned head with deformable regression alignment (reg_max 16)."""

    def __init__(self, nc: int, hidc: int, ch, strides, reg_max: int = 16):
        super().__init__()
        half = hidc // 2
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.share_conv_0 = Conv_GN(ch[0], half, 3)
        self.share_conv_1 = Conv_GN(half, half, 3)
        self.cls_decomp = TaskDecomposition(half, 2, 16)
        self.reg_decomp = TaskDecomposition(half, 2, 16)
        self.DyDCNV2 = DyDCNv2(half, half)
        self.spatial_conv_offset = _head_conv(hidc, 27, 3)
        self.cls_prob_conv1 = _head_conv(hidc, hidc // 4, 1)
        self.cls_prob_conv2 = _head_conv(hidc // 4, 1, 3)
        self.cv2 = _head_conv(half, 4 * reg_max, 1)
        self.cv3 = _head_conv(half, nc, 1)

    def forward(self, xs):
        """Returns (decoded (B, 4+nc, A), [raw map (B, no, h, w)]); in
        training (None, [raw map]), without the decode."""
        feats = []
        for x in xs:
            s1 = self.share_conv_0(x)
            s2 = self.share_conv_1(s1)
            feat = torch.cat([s1, s2], dim=1)
            avg_feat = feat.mean(dim=(2, 3), keepdim=True)
            cls_feat = self.cls_decomp(feat, avg_feat)
            reg_feat = self.reg_decomp(feat, avg_feat)
            om = self.spatial_conv_offset(feat)
            reg_feat = self.DyDCNV2(reg_feat, om[:, :18], torch.sigmoid(om[:, 18:]))
            cls_prob = torch.sigmoid(self.cls_prob_conv2(F.relu(self.cls_prob_conv1(feat))))
            feats.append(torch.cat([self.cv2(F.relu(reg_feat)),
                                    self.cv3(cls_feat * cls_prob)], dim=1))
        if self.training:
            return None, feats
        return decode_detections(feats, self.strides, self.nc, self.reg_max), feats


def _towers(module: nn.Module, ch, hidden: int, out: int) -> None:
    """The `cv4_{i}_{0,1,2}` tower of each level: two Conv+BN+SiLU, then a
    conv with bias to `out` channels."""
    for i, c in enumerate(ch):
        module.add_module(f"cv4_{i}_0", Conv(c, hidden, 3))
        module.add_module(f"cv4_{i}_1", Conv(hidden, hidden, 3))
        module.add_module(f"cv4_{i}_2", _head_conv(hidden, out, 1))


def _tower_flat(module: nn.Module, xs) -> torch.Tensor:
    """Every level's `cv4` tower output, (B, A, out) in the anchors' order."""
    outs = []
    for i, x in enumerate(xs):
        for j in range(3):
            x = getattr(module, f"cv4_{i}_{j}")(x)
        outs.append(x.flatten(2))
    return torch.cat(outs, dim=2).transpose(1, 2)


class Segment(nn.Module):
    """`Detect` (nested as `detect`, as the flax module nests it), the mask
    prototypes `proto` (`Proto` on the first level) and a mask-coefficient
    tower `cv4_{i}_{j}` per level. Returns (decoded (B, 4+nc+nm, A) or None
    in training, (raw maps, coefficients (B, A, nm), prototypes (B, nm,
    2h, 2w)))."""

    def __init__(self, nc: int, nm: int, npr: int, ch, strides, reg_max: int = 4):
        super().__init__()
        self.nc, self.nm, self.npr, self.reg_max = nc, nm, npr, reg_max
        self.strides = tuple(strides)
        self.proto = Proto(ch[0], npr, nm)
        _towers(self, ch, max(ch[0] // 4, nm), nm)
        self.detect = Detect(nc, ch, strides, reg_max)

    def forward(self, xs):
        proto = self.proto(xs[0])
        mc = _tower_flat(self, xs)
        decoded, feats = self.detect(xs)
        if decoded is None:
            return None, (feats, mc, proto)
        return torch.cat([decoded, mc.transpose(1, 2).to(decoded.dtype)], dim=1), \
            (feats, mc, proto)


class Pose(nn.Module):
    """`Detect` (nested as `detect`) and a keypoint tower `cv4_{i}_{j}` per
    level. In eval the keypoints are decoded against the anchor centres:
    xy as (raw * 2 + anchor - 0.5) * stride, the visibility through a
    sigmoid where `kpt_shape[1]` is 3. Returns (decoded (B, 4+nc+nk, A) or
    None in training, (raw maps, raw keypoints (B, A, nk)))."""

    def __init__(self, nc: int, kpt_shape, ch, strides, reg_max: int = 4):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        _towers(self, ch, max(ch[0] // 4, nk), nk)
        self.detect = Detect(nc, ch, strides, reg_max)

    def forward(self, xs):
        kpt = _tower_flat(self, xs)
        decoded, feats = self.detect(xs)
        if decoded is None:
            return None, (feats, kpt)
        b = kpt.shape[0]
        anchors, stride_t = make_anchors([f.shape[2:] for f in feats], self.strides, 0.5,
                                         device=kpt.device)
        k = kpt.reshape(b, -1, *self.kpt_shape)
        xy = (k[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :1]
        rest = torch.sigmoid(k[..., 2:]) if self.kpt_shape[1] == 3 else k[..., 2:]
        pk = torch.cat([xy, rest], dim=-1).reshape(b, -1, k.shape[2] * k.shape[3])
        return torch.cat([decoded, pk.transpose(1, 2).to(decoded.dtype)], dim=1), (feats, kpt)


class Classify(nn.Module):
    """The classification head: Conv (1280, k, s) + BN + SiLU, a global
    mean over the map, then a Linear `linear` to `c2` classes. Returns the
    logits in training and their softmax, taken in float32, in eval. As in
    JAX's, there is no dropout (the reference's `Dropout(p=0.0)`)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = Conv(c1, 1280, k, s)
        self.linear = nn.Linear(1280, c2)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(list(x), dim=1)
        y = self.linear(self.conv(x).mean(dim=(2, 3)))
        return y if self.training else torch.softmax(y.float(), dim=-1)
