"""The model graph: a layer list parsed from a config dict into one module.

The counterpart of `mgdt_yolo_tpu/nn/tasks.py`, with JAX's whole
vocabulary: any other type raises KeyError. `parse_model` keeps the JAX
package's channel arithmetic, including the GOLD-YOLO cases, RT-DETR's
(`HGStem`/`HGBlock` take their widths as given, `HGBlock`'s repeat count
goes in as its argument 4, `AIFI` keeps its input's width,
`RTDETRDecoder` gets its inputs' widths), the segment head's prototype
width and `depth_multiple`/`width_multiple` where a config has no
`scales`, and also tracks each layer's stride (strided convs and blocks,
max pools, transposed convs, `Focus`, `HGStem`) so the head's strides need
no probe run. A row repeated on a non-CSP module (`n > 1`) is an
`nn.Sequential` of `n` copies, which JAX names `model_i`, `model_i_rep1`,
...; a config's `activation:` reaches every module of its model built with
`act=True`. A config ending in `RTDETRDecoder` builds an
`RTDETRDetectionModel` (stride 32, as JAX's).
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import math
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..models import FLAGSHIP, load_config
from ..ops.deform import check_semantics
from .modules import block as B
from .modules import head as H
from .modules import transformer as T
from .modules.conv import (Concat, Conv, Conv2, ConvTranspose, DWConv, DWConvTranspose2d, Focus,
                           GhostConv, MaxPool2d, RepVGGBlock, Upsample, ZeroPad2d,
                           set_default_act)

LOGGER = logging.getLogger(__name__)


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round a channel count up to a multiple of divisor."""
    return math.ceil(x / divisor) * divisor


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the graph."""
    i: int                            # layer index
    f: Union[int, Tuple[int, ...]]    # input layer(s), -1 = previous
    name: str                         # module type
    args: Tuple[Any, ...]             # normalised args (c1 first where used)
    stride: int                       # output stride relative to the input
    n: int = 1                        # sequential repeats of a non-CSP module
    c2: int = 0                       # output channels (0 for a head)


_CONV_LIKE = {"Classify", "Conv", "Conv2", "ConvTranspose", "DWConvTranspose2d",
              "nn.ConvTranspose2d", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP",
              "SPPF", "DWConv", "Focus", "BottleneckCSP", "RepVGGBlock", "C1", "C2", "C2f",
              "MSPA_C2f", "C3", "C3x", "C3Ghost", "C3TR", "RepC3"}
_REPEAT_BLOCKS = {"BottleneckCSP", "C1", "C2", "C2f", "MSPA_C2f", "C3", "C3x", "C3Ghost",
                  "C3TR", "RepC3"}
_HEADS = {"Detect", "TOODHead", "Segment", "Pose"}
_KNOWN = _CONV_LIKE | _HEADS | {"nn.Upsample", "Concat", "nn.MaxPool2d", "nn.ZeroPad2d",
                                "SimFusion_4in", "SimFusion_3in", "IFM",
                                "InjectionMultiSum_Auto_pool", "HGStem", "HGBlock", "AIFI",
                                "RTDETRDecoder"}
# the conv-like types whose argument 3 (c1 and c2 first) is a stride, and
# the transposed ones whose argument 3 divides it (their default stride)
_STRIDED = {"Conv", "Conv2", "DWConv", "GhostConv", "RepVGGBlock", "GhostBottleneck"}
_UPSTRIDED = {"nn.ConvTranspose2d": 2, "ConvTranspose": 2, "DWConvTranspose2d": 1}


def parse_model(d: Dict, scale: Optional[str] = None):
    """Config dict -> (LayerSpecs, sorted save list, nc) for RGB input."""
    nc = d["nc"]
    depth, width = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0)
    max_channels = float("inf")
    if d.get("scales"):
        scale = scale or d.get("scale") or next(iter(d["scales"]))
        depth, width, max_channels = d["scales"][scale]

    chs, strides = [3], [1]
    specs, save = [], []
    for i, (f, n, m, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        if m not in _KNOWN:
            raise KeyError(f"unknown module type {m!r}")
        args = [nc if a == "nc" else a for a in args]
        n = max(round(n * depth), 1) if n > 1 else n
        fl = [f] if isinstance(f, int) else list(f)
        stride = strides[fl[0]]
        if m in _CONV_LIKE:
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
            if m in _REPEAT_BLOCKS:
                args.insert(2, n)
                n = 1
            if m in _STRIDED:
                stride *= args[3] if len(args) > 3 else 1
            elif m in _UPSTRIDED:
                stride //= args[3] if len(args) > 3 else _UPSTRIDED[m]
            elif m == "Focus":
                stride *= 2
        elif m in ("HGStem", "HGBlock"):
            c2 = args[1]
            args = [chs[f], *args]
            if m == "HGBlock":
                args.insert(4, n)
                n = 1
            else:
                stride *= 4
        elif m == "AIFI":
            c2 = chs[f]
            args = [c2, *args]
        elif m == "RTDETRDecoder":
            args.insert(1, [chs[x] for x in f])
            c2 = None
        elif m == "nn.MaxPool2d":
            c2 = chs[f]
            stride *= args[1] if len(args) > 1 else args[0]
        elif m == "nn.Upsample":
            c2 = chs[f]
            stride //= int(args[1])
        elif m == "Concat":
            c2 = sum(chs[x] for x in f)
        elif m in _HEADS:
            args.append([chs[x] for x in f])
            if m == "Segment":  # the prototypes' width scales as a layer's
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            c2 = None
        elif m == "SimFusion_4in":
            c2 = sum(chs[x] for x in f)
            stride = strides[fl[2]]
        elif m == "SimFusion_3in":
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [[chs[x] for x in f], c2]
            stride = strides[fl[1]]
        elif m == "IFM":
            c2 = sum(args[0])
            args = [chs[f], *args]
        elif m == "InjectionMultiSum_Auto_pool":
            c2 = args[0]
            args = [chs[f[0]], *args]
        else:  # nn.ZeroPad2d keeps its input's width
            c2 = chs[f]

        def _abs(j):
            return j if j == -1 else (j % i if j < 0 else j)

        f_norm = tuple(_abs(j) for j in f) if isinstance(f, list) else _abs(f)
        spec = LayerSpec(i, f_norm, m, tuple(args), stride, n, c2 or 0)
        specs.append(spec)
        save.extend(x % i for x in fl if x != -1)
        if i == 0:
            chs, strides = [], []
        chs.append(c2 if c2 else chs[-1])
        strides.append(stride)
    return tuple(specs), tuple(sorted(set(save))), nc


def build_module(spec: LayerSpec, head_strides, act=None) -> nn.Module:
    """Instantiate the module of one LayerSpec: `n` copies in an
    `nn.Sequential` where the row repeats (the first takes the row's input
    width, the others its output's), every `Conv` built with `act=True`
    given the config's activation `act` where there is one."""
    if spec.n > 1:
        a = spec.args
        mods = [_build_one(spec.name, a if r == 0 else (a[1], *a[1:]), head_strides)
                for r in range(spec.n)]
        module = nn.Sequential(*mods)
    else:
        module = _build_one(spec.name, spec.args, head_strides)
    return set_default_act(module, act) if act else module


def _build_one(m: str, a, head_strides) -> nn.Module:
    if m == "Conv":
        # (c1, c2, k, s, p, g, d, act): the v5 stem is Conv [64, 6, 2, 2]
        return Conv(a[0], a[1], *a[2:8])
    if m == "C2f":
        return B.C2f(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else False)
    if m == "MSPA_C2f":
        return B.MSPA_C2f(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else False)
    if m in ("C2", "C3"):
        return {"C2": B.C2, "C3": B.C3}[m](a[0], a[1], n=a[2],
                                           shortcut=a[3] if len(a) > 3 else True)
    if m == "Bottleneck":
        return B.Bottleneck(a[0], a[1], *a[2:])
    if m == "SPPF":
        return B.SPPF(a[0], a[1], a[2] if len(a) > 2 else 5)
    if m == "SPP":
        return B.SPP(a[0], a[1], a[2] if len(a) > 2 else (5, 9, 13))
    if m == "nn.ConvTranspose2d":  # the bare deconv: bias, no BatchNorm, no activation
        return ConvTranspose(a[0], a[1], a[2] if len(a) > 2 else 2, a[3] if len(a) > 3 else 2,
                             a[4] if len(a) > 4 else 0)
    if m == "ConvTranspose":  # (c2, k, s, p, bn, act), JAX's defaults (2, 2, 0, True, True)
        k, s, p, bn, act = [*a[2:7], *(2, 2, 0, True, True)[len(a[2:7]):]]
        return ConvTranspose(a[0], a[1], k, s, p, bn, act)
    if m == "DWConvTranspose2d":  # (c2, k, s, p1)
        return DWConvTranspose2d(a[0], a[1], *a[2:5])
    if m == "Conv2":  # JAX's builds (c2, k, s) only
        return Conv2(a[0], a[1], a[2] if len(a) > 2 else 3, a[3] if len(a) > 3 else 1)
    if m == "DWConv":  # (c2, k, s, d, act): RT-DETR's downsamplers pass act False
        return DWConv(a[0], a[1], *a[2:6])
    if m == "GhostConv":  # JAX's builds (c2, k, s)
        return GhostConv(a[0], a[1], *a[2:4])
    if m == "Focus":  # JAX's builds (c2, k)
        return Focus(a[0], a[1], a[2] if len(a) > 2 else 1)
    if m == "RepVGGBlock":  # (c2, k, s)
        return RepVGGBlock(a[0], a[1], a[2] if len(a) > 2 else 3, a[3] if len(a) > 3 else 1)
    if m == "GhostBottleneck":  # (c2, k, s)
        return B.GhostBottleneck(a[0], a[1], *a[2:4])
    if m in ("C3x", "C3Ghost", "BottleneckCSP"):  # JAX's builds (c2, n, shortcut)
        cls = {"C3x": B.C3x, "C3Ghost": B.C3Ghost, "BottleneckCSP": B.BottleneckCSP}[m]
        return cls(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else True)
    if m in ("C1", "RepC3", "C3TR"):  # JAX's builds (c2, n)
        return {"C1": B.C1, "RepC3": B.RepC3, "C3TR": B.C3TR}[m](a[0], a[1], n=a[2])
    if m == "HGStem":  # (c1, cm, c2)
        return B.HGStem(a[0], a[1], a[2])
    if m == "HGBlock":  # (c1, cm, c2, k, n, lightconv, shortcut)
        return B.HGBlock(a[0], a[1], a[2], *a[3:7])
    if m == "AIFI":  # (c1, cm, num_heads)
        return T.AIFI(*a[:3])
    if m == "RTDETRDecoder":  # (nc, ch, hd)
        return T.RTDETRDecoder(nc=a[0], ch=tuple(a[1]), **({"hd": a[2]} if len(a) > 2 else {}))
    if m == "nn.MaxPool2d":  # (k, s, p), torch's order
        return MaxPool2d(a[0], a[1] if len(a) > 1 else a[0], a[2] if len(a) > 2 else 0)
    if m == "nn.ZeroPad2d":
        return ZeroPad2d(a[0])
    if m == "SimFusion_4in":
        return B.SimFusion_4in()
    if m == "SimFusion_3in":
        return B.SimFusion_3in(a[0], a[1])
    if m == "IFM":
        return B.IFM(a[0], a[1])
    if m == "InjectionMultiSum_Auto_pool":
        return B.InjectionMultiSum_Auto_pool(a[0], a[1], a[2], a[3])
    if m == "nn.Upsample":
        return Upsample(int(a[1]), a[2])
    if m == "Concat":
        return Concat()
    if m == "Detect":
        return H.Detect(a[0], a[-1], head_strides)
    if m == "TOODHead":
        return H.TOODHead(a[0], a[1], a[-1], head_strides)
    if m == "Segment":
        return H.Segment(a[0], a[1], a[2], a[-1], head_strides)
    if m == "Pose":
        return H.Pose(a[0], a[1], a[-1], head_strides)
    if m == "Classify":  # JAX's builds it from c2 alone: k = s = 1
        return H.Classify(a[0], a[1])
    raise KeyError(f"unknown module type {m!r}")


def scaled_yaml_name(name: Optional[str], scale: Optional[str]) -> Optional[str]:
    """The YAML file name that builds `name` at `scale`, as the JAX package
    reads a scale from a name (`guess_model_scale`): "thead_yolov8.yaml" at
    "s" is "thead_yolov8s.yaml", and a letter the name carries is replaced.
    `name` as it is without a scale; None where no name can carry it."""
    if name is None or not scale:
        return name
    new, n = re.subn(r"(yolov\d+)[nslmx]?", rf"\g<1>{scale}", name, count=1)
    return new if n else None


def _scale_img(img: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """NHWC scale-and-pad to a `gs`-multiple canvas, the JAX `_scale_img`:
    a bilinear resize without antialias (half-pixel centres), then the
    bottom and right padded with 0.447."""
    if ratio == 1.0:
        return img
    b, h, w, c = img.shape
    nh, nw = int(h * ratio), int(w * ratio)
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                        align_corners=False, antialias=False)
    ph, pw = math.ceil(h * ratio / gs) * gs, math.ceil(w * ratio / gs) * gs
    out = F.pad(out, (0, pw - nw, 0, ph - nh), value=0.447)
    return out.permute(0, 2, 3, 1)


def _descale_pred(p: torch.Tensor, flip: Optional[int], scale: float, img_size) -> torch.Tensor:
    """Undo a TTA pass's scale and flip on decoded predictions (B, 4+nc, A),
    xywh in channels 0:4 (the JAX `_descale_pred`; 2 flips up-down, 3
    left-right)."""
    xy_wh = p[:, :4] / scale
    x, y, wh = xy_wh[:, 0:1], xy_wh[:, 1:2], xy_wh[:, 2:4]
    if flip == 2:
        y = img_size[0] - y
    elif flip == 3:
        x = img_size[1] - x
    return torch.cat((x, y, wh, p[:, 4:]), dim=1)


class BaseModel(nn.Module):
    """What the port's models share: the graph built from a config (a dict,
    or the YAML file name of one of `models.CONFIGS`; a scale letter as in
    "yolov8s.yaml" picks that scale), `nc` overriding the config's class
    count as JAX's `nc=` does, its layers as the attributes `model_0` ...
    `model_N`, named as the flax graph names them, every layer run (also
    those whose output reaches no head, the thead models' 19-21, as in the
    JAX graph), the port's seeded init, loading and folding. A new model is
    in `eval()` mode on `device` (CUDA by default)."""

    default_cfg = FLAGSHIP

    def _build(self, cfg, scale, nc, head_strides=None) -> Dict:
        cfg = copy.deepcopy(cfg) if isinstance(cfg, dict) else load_config(
            cfg or self.default_cfg)
        if nc:
            cfg["nc"] = nc
        # the config a checkpoint's metadata names, as the JAX exporter does,
        # with a `scale` given here written into it as JAX names a scale
        # (None for a dict of no file: such a model's checkpoint is refused)
        self.model_yaml = scaled_yaml_name(cfg.get("yaml_file"), scale)
        self.specs, self.save, self.nc = parse_model(cfg, scale=scale)
        self.names = {i: f"{i}" for i in range(self.nc)}
        self.act = cfg.get("activation")  # YOLOv6's "nn.ReLU()"
        self.deform_semantics = "windowed"
        if head_strides is None:
            if self.specs[-1].name == "RTDETRDecoder":
                raise ValueError(f"{self.model_yaml or 'the config'} is an RT-DETR model: build "
                                 f"it as an RTDETRDetectionModel (or mgdt_yolo_tpu_torch.vit."
                                 f"RTDETR)")
            if self.specs[-1].name not in _HEADS:
                raise ValueError(f"{self.model_yaml or 'the config'} ends in "
                                 f"{self.specs[-1].name}, not a detection head: build it as a "
                                 f"ClassificationModel")
            head_strides = tuple(self.specs[j].stride for j in self.specs[-1].f)
        self.stride = head_strides
        for spec in self.specs:
            self.add_module(f"model_{spec.i}", build_module(spec, self.stride, self.act))
        return cfg

    @classmethod
    def from_npz(cls, path, device=None):
        """The model a flat flax npz holds: the config and `nc` that
        `<stem>_metadata.json` beside it names (`model_yaml`, `nc`; the
        class's default config where it names none), filled from the npz,
        pinned to the deform semantics the metadata records and named by
        its class `names`."""
        from ..weights import load_npz, read_metadata
        dev = resolve_device(device)
        meta = read_metadata(path)
        model = cls(meta.get("model_yaml"), nc=meta.get("nc"), device="cpu")
        load_npz(model, path)
        names = meta.get("names")
        if isinstance(names, dict) and len(names) == model.nc:
            model.names = {int(k): str(v) for k, v in names.items()}
        return model.to(dev)

    @classmethod
    def from_pt(cls, path, device=None, strict: bool = False):
        """(model, checkpoint) of a reference `.pt` (its path, or the file
        `utils.torch_import.read_torch_pt` read): the config `train_args["model"]` names (JAX's
        `yolov8n.yaml` where it names none) with the pickled model's class
        count and names where it has them, filled from the EMA weights
        (float32; non-strict unless `strict`, as
        `utils.torch_import.load_torch_state_dict`), the import's report in
        `model.import_report`, and pinned to exact deform semantics:
        reference weights were trained with mmcv's unbounded DCNv2."""
        from ..utils.torch_import import PtCheckpoint, load_torch_state_dict, read_torch_pt
        dev = resolve_device(device)
        pt = path if isinstance(path, PtCheckpoint) else read_torch_pt(path)
        model = cls(pt.train_args.get("model") or "yolov8n.yaml", nc=pt.nc, device="cpu")
        model.set_deform_semantics("exact")
        model.import_report = load_torch_state_dict(model, pt.state_dict, strict=strict)
        if pt.names and len(pt.names) == model.nc:
            model.names = dict(pt.names)
        return model.to(dev), pt

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def set_deform_semantics(self, sem: str):
        """Pin this model's DCNv2 semantics ('windowed' or 'exact')."""
        self.deform_semantics = check_semantics(sem)
        for m in self.modules():
            if isinstance(m, B.DyDCNv2):
                m.semantics = sem
        return self

    def fuse(self):
        """Fold every Conv+BN pair (call before casting to bfloat16)."""
        from .fuse import fuse_conv_bn
        self.n_fused = fuse_conv_bn(self)
        return self

    def _run(self, x: torch.Tensor, head_kwargs=None, upto: Optional[int] = None):
        """The graph over an NHWC batch: the last layer's output (the last
        layer called with `head_kwargs`, where given); with `upto`, the
        output of its first `upto` layers."""
        x = x.to(next(self.parameters()).dtype)
        saved, out = {}, x.permute(0, 3, 1, 2)
        last = self.specs[-1].i
        for spec in self.specs[:upto]:
            if spec.f == -1:
                inp = out
            elif isinstance(spec.f, int):
                inp = saved[spec.f]
            else:
                inp = [out if j == -1 else saved[j] for j in spec.f]
            if head_kwargs and spec.i == last:
                out = getattr(self, f"model_{spec.i}")(inp, **head_kwargs)
            else:
                out = getattr(self, f"model_{spec.i}")(inp)
            if spec.i in self.save:
                saved[spec.i] = out
        return out

    @torch.no_grad()
    def _init_params(self):
        """Deterministic init with the JAX package's distributions: kernels
        uniform(+-sqrt(1/fan_in)) from a seeded generator, norm scales and
        variances 1, the rest 0."""
        gen = torch.Generator().manual_seed(0)
        transposed = {f"{n}.weight" for n, m in self.named_modules()
                      if isinstance(m, nn.ConvTranspose2d)}
        for name, p in list(self.named_parameters()) + list(self.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight", "reduction_weight") and p.dim() >= 2:
                hwio = leaf == "reduction_weight" or name.endswith("DyDCNV2.weight")
                if hwio:
                    fan_in = p.shape[0] * p.shape[1] * p.shape[2]
                elif name in transposed:
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]  # (in, out, kh, kw)
                else:
                    fan_in = p[0].numel()
                bound = math.sqrt(1.0 / fan_in)
                p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
            elif leaf in ("weight", "running_var"):
                p.fill_(1.0)
            elif p.is_floating_point():
                p.zero_()


class DetectionModel(BaseModel):
    """A detection model built from a config (see `BaseModel`), by default
    the flagship.

    `forward` takes an NHWC float image batch and returns (decoded (B,
    4+nc, A), [raw map (B, h, w, no) per level]), as the JAX
    `DetectionModel.predict` does; in `train()` mode decoded is None and
    BatchNorm uses and updates batch statistics (`forward_feats`).

    A `Segment` head makes the second element (raw maps, mask coefficients
    (B, A, nm), prototypes (B, mh, mw, nm)) and `decoded` (B, 4+nc+nm, A);
    a `Pose` head (raw maps, raw keypoints (B, A, nk)) and (B, 4+nc+nk, A),
    as the JAX heads return them. `task` follows the head.
    """

    def __init__(self, cfg: Union[None, str, Dict] = None, scale: Optional[str] = None,
                 device=None, nc: Optional[int] = None):
        super().__init__()
        cfg = self._build(cfg, scale, nc)
        head = getattr(self, f"model_{self.specs[-1].i}")
        self.reg_max = head.reg_max
        self.task = {H.Segment: "segment", H.Pose: "pose"}.get(type(head), "detect")
        # JAX's trainer and validator read the config's `kpt_shape`
        self.kpt_shape = tuple(cfg.get("kpt_shape", (17, 3)))
        self._init_weights()
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x: torch.Tensor):
        decoded, aux = self._run(x)
        if isinstance(aux, tuple):  # Segment / Pose: (maps, coefficients or keypoints[, protos])
            maps, *rest = aux
            return decoded, ([f.permute(0, 2, 3, 1) for f in maps],
                             *(r.permute(0, 2, 3, 1) if r.dim() == 4 else r for r in rest))
        return decoded, [f.permute(0, 2, 3, 1) for f in aux]

    def predict_augment(self, x: torch.Tensor):
        """Test-time augmentation, the JAX `predict_augment`: the eval
        forward at scales 1, 0.83 and 0.67 of the NHWC batch `x`, the middle
        one flipped left-right, each de-scaled, the large-object tail of the
        first and the small-object head of the last dropped
        (`_clip_augmented`), concatenated along the anchors. Returns
        (decoded (B, 4+nc, A_total), None)."""
        img_h, img_w = x.shape[1], x.shape[2]
        gs = int(max(self.stride))
        ys = []
        for si, fi in zip((1.0, 0.83, 0.67), (None, 3, None)):
            xi = torch.flip(x, dims=(2,)) if fi == 3 else x
            yi, _ = self(_scale_img(xi, si, gs))
            ys.append(_descale_pred(yi, fi, si, (img_h, img_w)))
        return torch.cat(self._clip_augmented(ys), dim=-1), None

    def _clip_augmented(self, y):
        """Drop the first pass's large-object anchors and the last pass's
        small-object anchors, with the JAX package's (and the reference's)
        arithmetic: on a one-level head each pass drops all of its anchors."""
        nl = len(self.stride)
        g = sum(4 ** k for k in range(nl))
        i = (y[0].shape[-1] // g) * 1
        y[0] = y[0][..., :-i]
        i = (y[-1].shape[-1] // g) * 4 ** (nl - 1)
        y[-1] = y[-1][..., i:]
        return y

    def forward_feats(self, x: torch.Tensor):
        """Training forward: the raw NHWC maps (a segment or pose model's
        tuple with them), as the JAX `forward_feats` returns them (call
        `train()` first for batch statistics)."""
        return self(x)[1]

    @torch.no_grad()
    def _init_weights(self):
        """`_init_params`, then the head's prior biases."""
        self._init_params()
        head = getattr(self, f"model_{self.specs[-1].i}")
        if isinstance(head, H.TOODHead):
            # the reference's quirk: stride 16 whatever the head's stride
            head.cv2.bias.fill_(1.0)
            head.cv3.bias.fill_(math.log(5 / self.nc / (640 / 16) ** 2))
        else:
            head = getattr(head, "detect", head)  # Segment / Pose nest their Detect
            for i, s in enumerate(self.stride):
                getattr(head, f"cv2_{i}_2").bias.fill_(1.0)
                getattr(head, f"cv3_{i}_2").bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))


class SegmentationModel(DetectionModel):
    """A model of the segment task (`yolov8-seg.yaml` by default), as the
    JAX `SegmentationModel`."""

    def __init__(self, cfg="yolov8n-seg.yaml", scale=None, device=None, nc=None):
        super().__init__(cfg, scale=scale, device=device, nc=nc)


class PoseModel(DetectionModel):
    """A model of the pose task (`yolov8-pose.yaml` by default), as the
    JAX `PoseModel`."""

    def __init__(self, cfg="yolov8n-pose.yaml", scale=None, device=None, nc=None):
        super().__init__(cfg, scale=scale, device=device, nc=nc)


class ClassificationModel(BaseModel):
    """A model of the classify task (`yolov8-cls.yaml` by default, nc 1000),
    as the JAX `ClassificationModel`: the graph ending in `Classify`,
    `stride` (1,). `forward` takes an NHWC float batch and returns the
    logits (B, nc) in `train()` mode and their float32 softmax in eval."""

    default_cfg = "yolov8n-cls.yaml"
    task = "classify"

    def __init__(self, cfg: Union[None, str, Dict] = "yolov8n-cls.yaml",
                 scale: Optional[str] = None, device=None, nc: Optional[int] = None):
        super().__init__()
        self._build(cfg, scale, nc, head_strides=(1,))
        if self.specs[-1].name != "Classify":
            raise ValueError(f"{self.model_yaml or 'the config'} ends in "
                             f"{self.specs[-1].name}, not Classify")
        self._init_params()
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x)


class RTDETRDetectionModel(BaseModel):
    """An RT-DETR model (`rtdetr-l.yaml` by default; `rtdetr-x.yaml`,
    `yolov8-rtdetr.yaml` at its scales): the graph ending in
    `RTDETRDecoder`, stride (32,) as JAX's, the port's seeded init (JAX's
    distributions: the decoder's biases and class embedding at 0).

    `forward(x, dn=None)` takes an NHWC float batch and returns the head's
    (dec_bboxes, dec_scores, enc_bboxes, enc_scores, dn_meta), as the JAX
    model's first output (`nn.modules.transformer.RTDETRDecoder`): in
    `eval()` mode the last layer's normalised xywh boxes (1, b, nq, 4) and
    sigmoid scores (1, b, nq, nc); in `train()` mode every decoder layer's,
    with the denoising group of `dn` where given.

    `from_pt(path, device=None)` reads a reference `.pt` as
    `DetectionModel.from_pt` does: the config its `train_args` name (a file
    that names none, or names no RT-DETR config, is refused), the pickled
    class count and names, the EMA weights in float32, the import's report
    in `import_report`. It reads strictly: a file with a key the import
    cannot place, or one that leaves a tensor of the model at its init,
    raises KeyError naming them (JAX's `YOLO(pt)` serves no RT-DETR, so
    no file should load in part)."""

    default_cfg = "rtdetr-l.yaml"
    task = "detect"

    def __init__(self, cfg: Union[None, str, Dict] = "rtdetr-l.yaml",
                 scale: Optional[str] = None, device=None, nc: Optional[int] = None):
        super().__init__()
        self._build(cfg, scale, nc, head_strides=(32,))
        if self.specs[-1].name != "RTDETRDecoder":
            raise ValueError(f"{self.model_yaml or 'the config'} ends in "
                             f"{self.specs[-1].name}, not RTDETRDecoder")
        self._init_params()
        self.to(resolve_device(device))
        self.eval()

    @classmethod
    def from_pt(cls, path, device=None):
        return super().from_pt(path, device, strict=True)

    def forward(self, x: torch.Tensor, dn=None):
        return self._run(x, {"dn": dn} if dn is not None else None)


def guess_model_scale(path) -> str:
    """The n/s/m/l/x scale letter of a name like yolov8s.yaml, "" where it
    has none (JAX `nn/tasks.py:402-405`)."""
    m = re.search(r"yolov\d+([nslmx])", Path(str(path)).stem)
    return m.group(1) if m else ""


def yaml_model_load(path) -> Dict:
    """The config a model YAML's file name names, resolved over the port's
    own configs (`models.CONFIGS`; a scale letter picks that scale, kept as
    `scale`), with `yaml_file` the name given, as JAX's `yaml_model_load`
    (`nn/tasks.py:408-423`) resolves it over its YAML files. Raises
    FileNotFoundError for a name the port has no config for."""
    try:
        d = load_config(path)
    except KeyError as e:
        raise FileNotFoundError(f"model yaml '{path}' not found: {e.args[0]}") from None
    d["scale"] = guess_model_scale(path)
    d["yaml_file"] = str(path)
    return d


class Ensemble(nn.Module):
    """An NMS ensemble of detection models (JAX `nn/tasks.py:608-654`):
    `forward(x)` returns (the members' decoded outputs concatenated on the
    anchor axis, None), so NMS runs over every member's candidates at once.
    Its stride is that of the member with the largest stride; `nc`, `names`,
    `task` and `reg_max` are the first member's; `fuse` and
    `set_deform_semantics` go to every member. Members of different class
    counts raise. The predictor and the validators take it as a model."""

    def __init__(self, members):
        super().__init__()
        members = list(members)
        if not members or any(m.nc != members[0].nc for m in members):
            raise ValueError(f"models differ in class counts {[m.nc for m in members]}")
        self.members = nn.ModuleList(members)
        first = members[0]
        self.nc, self.names = first.nc, first.names
        self.task = getattr(first, "task", "detect")
        self.reg_max = first.reg_max
        self.stride = max((m.stride for m in members), key=max)

    def __len__(self) -> int:
        return len(self.members)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def deform_semantics(self) -> str:
        return self.members[0].deform_semantics

    def forward(self, x: torch.Tensor):
        return torch.cat([m(x)[0] for m in self.members], dim=-1), None

    def fuse(self):
        for m in self.members:
            m.fuse()
        return self

    def set_deform_semantics(self, sem: str):
        """Pin every member (a member loaded from a checkpoint keeps its own
        pin until this is called)."""
        for m in self.members:
            m.set_deform_semantics(sem)
        return self


def attempt_load_one_weight(weight, device=None, fuse: bool = False):
    """The model of one checkpoint (npz, `.pt`) or config YAML, loaded
    through the port's `YOLO` onto `device` (the card by default), folded
    where `fuse` (JAX `nn/tasks.py:657-664`)."""
    from ..engine.model import YOLO
    model = YOLO(str(weight), device=device).model
    return model.fuse() if fuse else model


def attempt_load_weights(weights, device=None, fuse: bool = False):
    """One model, or an `Ensemble` of the models of a list of checkpoints
    (JAX `nn/tasks.py:667-676`)."""
    ws = weights if isinstance(weights, (list, tuple)) else [weights]
    members = [attempt_load_one_weight(w, device, fuse) for w in ws]
    if len(members) == 1:
        return members[0]
    LOGGER.info(f"Ensemble created with {[str(w) for w in ws]}")
    return Ensemble(members)


def is_rtdetr(cfg) -> bool:
    """Whether a config (a dict or a YAML file name) ends in RTDETRDecoder."""
    if not isinstance(cfg, dict):
        try:
            cfg = load_config(cfg)
        except KeyError:
            return False
    return str(cfg.get("head", [[""]])[-1][-2]) == "RTDETRDecoder"


def model_class(cfg) -> type:
    """The model class of a config (a dict or a YAML file name):
    `RTDETRDetectionModel` where it ends in RTDETRDecoder, else by the task
    `guess_model_task` reads from it: `ClassificationModel` for classify,
    else `DetectionModel` (whose head gives the segment and pose tasks)."""
    if cfg and is_rtdetr(cfg):
        return RTDETRDetectionModel
    return ClassificationModel if guess_model_task(cfg or "") == "classify" else DetectionModel


def guess_model_task(cfg) -> str:
    """The task a config dict's head, or a model's name, implies, as the
    JAX `guess_model_task` reads it: classify, segment, pose, else detect
    (`TOODHead` included)."""
    if isinstance(cfg, dict):
        head = str(cfg.get("head", [[""]])[-1][-2]).lower()
    else:
        head = str(cfg).lower()
    if "classify" in head or "-cls" in head:
        return "classify"
    if "segment" in head or "-seg" in head:
        return "segment"
    if "pose" in head or "-pose" in head:
        return "pose"
    return "detect"
