"""The model graph: a layer list parsed from a config dict into one module.

The counterpart of `mgdt_yolo_tpu/nn/tasks.py`, cut to the module types the
eight models of the ablation matrix use (`models.CONFIGS`); any other type
raises KeyError. `parse_model` keeps the JAX package's channel arithmetic,
including the GOLD-YOLO cases, and also tracks each layer's stride so the
head's strides need no probe run.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..models import FLAGSHIP, load_config
from ..ops.deform import check_semantics
from .modules import block as B
from .modules import head as H
from .modules.conv import Concat, Conv, Upsample


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


_CONV_LIKE = {"Conv", "SPPF", "C2f", "MSPA_C2f"}
_REPEAT_BLOCKS = {"C2f", "MSPA_C2f"}
_HEADS = {"Detect", "TOODHead"}
_KNOWN = _CONV_LIKE | _HEADS | {"nn.Upsample", "Concat", "SimFusion_4in", "SimFusion_3in",
                                "IFM", "InjectionMultiSum_Auto_pool"}


def parse_model(d: Dict, scale: Optional[str] = None):
    """Config dict -> (LayerSpecs, sorted save list, nc) for RGB input."""
    nc = d["nc"]
    depth, width, max_channels = 1.0, 1.0, float("inf")
    if d.get("scales"):
        scale = scale or d.get("scale") or next(iter(d["scales"]))
        depth, width, max_channels = d["scales"][scale]

    chs, strides = [3], [1]
    specs, save = [], []
    for i, (f, n, m, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        if m not in _KNOWN:
            raise KeyError(f"module type {m!r} is not ported")
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
            if m == "Conv":
                stride *= args[3] if len(args) > 3 else 1
        elif m == "nn.Upsample":
            c2 = chs[f]
            stride //= int(args[1])
        elif m == "Concat":
            c2 = sum(chs[x] for x in f)
        elif m in _HEADS:
            args.append([chs[x] for x in f])
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
        else:  # InjectionMultiSum_Auto_pool
            c2 = args[0]
            args = [chs[f[0]], *args]
        if n != 1:
            raise KeyError(f"sequential repeats of {m!r} are not ported")

        def _abs(j):
            return j if j == -1 else (j % i if j < 0 else j)

        f_norm = tuple(_abs(j) for j in f) if isinstance(f, list) else _abs(f)
        spec = LayerSpec(i, f_norm, m, tuple(args), stride)
        specs.append(spec)
        save.extend(x % i for x in fl if x != -1)
        if i == 0:
            chs, strides = [], []
        chs.append(c2 if c2 else chs[-1])
        strides.append(stride)
    return tuple(specs), tuple(sorted(set(save))), nc


def build_module(spec: LayerSpec, head_strides) -> nn.Module:
    """Instantiate the module of one LayerSpec."""
    a, m = spec.args, spec.name
    if m == "Conv":
        if len(a) > 4:
            raise KeyError("Conv padding, groups, dilation and activation "
                           "arguments are not ported")
        return Conv(a[0], a[1], a[2] if len(a) > 2 else 1, a[3] if len(a) > 3 else 1)
    if m == "C2f":
        return B.C2f(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else False)
    if m == "MSPA_C2f":
        return B.MSPA_C2f(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else False)
    if m == "SPPF":
        return B.SPPF(a[0], a[1], a[2] if len(a) > 2 else 5)
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
    raise KeyError(f"module type {m!r} is not ported")


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


class DetectionModel(nn.Module):
    """A detection model built from a config: a dict, or the YAML file name
    of one of `models.CONFIGS` ("thead_yolov8.yaml"; a scale letter as in
    "yolov8s.yaml" picks that scale), by default the flagship. `nc`
    overrides the config's class count, as the JAX `DetectionModel(cfg,
    nc=...)` does.

    Layers are the attributes `model_0` ... `model_N`, named as the flax
    graph names them; every layer runs, also those whose output reaches no
    head (the thead models' 19-21), as in the JAX graph. `forward` takes an
    NHWC float image batch and returns (decoded (B, 4+nc, A), [raw map
    (B, h, w, no) per level]), as the JAX `DetectionModel.predict` does; in
    `train()` mode decoded is None and BatchNorm uses and updates batch
    statistics (`forward_feats`). A new model is in `eval()` mode.
    """

    def __init__(self, cfg: Union[None, str, Dict] = None, scale: Optional[str] = None,
                 device=None, nc: Optional[int] = None):
        super().__init__()
        cfg = copy.deepcopy(cfg) if isinstance(cfg, dict) else load_config(cfg or FLAGSHIP)
        if nc:
            cfg["nc"] = nc
        # the config a checkpoint's metadata names, as the JAX exporter does,
        # with a `scale` given here written into it as JAX names a scale
        # (None for a dict of no file: such a model's checkpoint is refused)
        self.model_yaml = scaled_yaml_name(cfg.get("yaml_file"), scale)
        self.specs, self.save, self.nc = parse_model(cfg, scale=scale)
        self.names = {i: f"{i}" for i in range(self.nc)}
        self.stride = tuple(self.specs[j].stride for j in self.specs[-1].f)
        for spec in self.specs:
            self.add_module(f"model_{spec.i}", build_module(spec, self.stride))
        self.reg_max = getattr(self, f"model_{self.specs[-1].i}").reg_max
        self.deform_semantics = "windowed"
        self._init_weights()
        self.to(resolve_device(device))
        self.eval()

    @classmethod
    def from_npz(cls, path, device=None):
        """The model a flat flax npz holds: the config and `nc` that
        `<stem>_metadata.json` beside it names (`model_yaml`, `nc`; the
        flagship where it names no config), filled from the npz, pinned to
        the deform semantics the metadata records and named by its class
        `names`."""
        from ..weights import load_npz, read_metadata
        dev = resolve_device(device)
        meta = read_metadata(path)
        model = cls(meta.get("model_yaml"), nc=meta.get("nc"), device="cpu")
        load_npz(model, path)
        names = meta.get("names")
        if isinstance(names, dict) and len(names) == model.nc:
            model.names = {int(k): str(v) for k, v in names.items()}
        return model.to(dev)

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

    def forward(self, x: torch.Tensor):
        x = x.to(next(self.parameters()).dtype)
        saved, out = {}, x.permute(0, 3, 1, 2)
        for spec in self.specs:
            if spec.f == -1:
                inp = out
            elif isinstance(spec.f, int):
                inp = saved[spec.f]
            else:
                inp = [out if j == -1 else saved[j] for j in spec.f]
            out = getattr(self, f"model_{spec.i}")(inp)
            if spec.i in self.save:
                saved[spec.i] = out
        decoded, feats = out
        return decoded, [f.permute(0, 2, 3, 1) for f in feats]

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
        """Training forward: the raw NHWC maps, as the JAX `forward_feats`
        returns them (call `train()` first for batch statistics)."""
        return self(x)[1]

    @torch.no_grad()
    def _init_weights(self):
        """Deterministic init with the JAX package's distributions: kernels
        uniform(+-sqrt(1/fan_in)) from a seeded generator, norm scales and
        variances 1, the rest 0, then the head's prior biases."""
        gen = torch.Generator().manual_seed(0)
        for name, p in list(self.named_parameters()) + list(self.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight", "reduction_weight") and p.dim() >= 2:
                hwio = leaf == "reduction_weight" or name.endswith("DyDCNV2.weight")
                fan_in = p.shape[0] * p.shape[1] * p.shape[2] if hwio else p[0].numel()
                bound = math.sqrt(1.0 / fan_in)
                p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
            elif leaf in ("weight", "running_var"):
                p.fill_(1.0)
            elif p.is_floating_point():
                p.zero_()
        head = getattr(self, f"model_{self.specs[-1].i}")
        if isinstance(head, H.TOODHead):
            # the reference's quirk: stride 16 whatever the head's stride
            head.cv2.bias.fill_(1.0)
            head.cv3.bias.fill_(math.log(5 / self.nc / (640 / 16) ** 2))
        else:
            for i, s in enumerate(self.stride):
                getattr(head, f"cv2_{i}_2").bias.fill_(1.0)
                getattr(head, f"cv3_{i}_2").bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))


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
