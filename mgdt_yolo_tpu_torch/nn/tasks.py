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
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

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
        # the config a checkpoint's metadata names, as the JAX exporter does
        # (None for a dict of no file)
        self.model_yaml = cfg.get("yaml_file")
        self.specs, self.save, self.nc = parse_model(cfg, scale=scale)
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
        flagship where it names no config), filled from the npz and pinned
        to the deform semantics the metadata records."""
        from ..weights import load_npz, read_metadata
        dev = resolve_device(device)
        meta = read_metadata(path)
        model = cls(meta.get("model_yaml"), nc=meta.get("nc"), device="cpu")
        load_npz(model, path)
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
