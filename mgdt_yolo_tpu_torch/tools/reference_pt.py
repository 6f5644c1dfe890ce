"""Write a port model as a reference `.pt` checkpoint, for the tests and
`chip_smoke.py`: the inverse of `utils.torch_import`.

A reference checkpoint pickles the fork's `nn.Module` graph (`trainer.py:
411-436` of the reference): `{"model": graph, "ema": graph, "train_args":
{"model": <YAML>, ...}, ...}`, every tensor in half precision. The graph
here is built from classes named and placed as the reference's are
(`ultralytics.nn.tasks.DetectionModel`, `ultralytics.nn.modules.block.
MSPA_C2f`, mmcv's `ModulatedDeformConv2d`, ...), registered as modules
only while `torch.save` runs, so they do not import when the file is
read, as the fork's classes do not import beside the JAX package or the
port. Its state-dict names are the reference's: `reference_key` inverts
`torch_import.translate_key`, and every name written is checked to
translate back to the flax path and the value it came from.

An RT-DETR model is written as a pickled `RTDETRDetectionModel` in the
JAX importer's layout: its HGNetV2 blocks, `RepC3`, `DWConv`, `AIFI` and
`RTDETRDecoder` under the reference's modules, the decoder's inner modules
as the reference's own (`ultralytics.nn.modules.transformer`) and torch's
layers, an attention's q/k/v packed into `nn.MultiheadAttention`'s
`in_proj_weight` and `in_proj_bias`. AIFI's encoder layer and each
`DWConv`'s convolution keep the nesting both importers read, one level
down (`model.11.enc.*`, `model.2.conv.conv.weight`); a file that names
them otherwise is name-missed by both, and refused by the port's
`RTDETRDetectionModel.from_pt`.

Nothing of the port's entry points reaches this module.
"""
from __future__ import annotations

import contextlib
import re
import sys
import types
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models import load_config
from ..utils.torch_import import translate_key
from ..weights import export_variables

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_INDEXED = ("m", "convs", "bottleneck", "share_conv", "tr")
_TRANSFORMER = "ultralytics.nn.modules.transformer"
# where the reference keeps each layer type's class
_LAYER_MODULES = {"Conv": "conv", "Concat": "conv", "C2f": "block", "MSPA_C2f": "block",
                  "C2": "block", "C3": "block", "SPP": "block", "Bottleneck": "block",
                  "SPPF": "block", "SimFusion_4in": "block", "SimFusion_3in": "block",
                  "IFM": "block", "InjectionMultiSum_Auto_pool": "block", "Detect": "head",
                  "TOODHead": "head", "Segment": "head", "Pose": "head", "Classify": "head",
                  "HGStem": "block", "HGBlock": "block", "RepC3": "block", "DWConv": "conv",
                  "AIFI": "transformer", "RTDETRDecoder": "head"}
# graph rows that are torch's own modules in the reference
_TORCH_LAYERS = {"nn.Upsample": torch.nn.Upsample, "nn.MaxPool2d": torch.nn.MaxPool2d,
                 "nn.ZeroPad2d": torch.nn.ZeroPad2d,
                 "nn.ConvTranspose2d": torch.nn.ConvTranspose2d}


def _oihw(a: np.ndarray) -> np.ndarray:
    """flax HWIO -> torch OIHW."""
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))


def _t(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def reference_key(flax_key: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flat flax key and its array -> (the reference's state-dict key,
    the array in torch's layout)."""
    coll, _, path = flax_key.partition(".")
    p = path.split(".")
    leaf = p[-1]
    if "DyDCNV2" in p:
        i = p.index("DyDCNV2") + 1
        rest = p[i:]
        if rest == ["weight"]:
            p, value = p[:i] + ["conv", "weight"], _oihw(value)
        elif rest == ["bias"]:
            p = p[:i] + ["conv", "bias"]
        elif rest[0] == "gn":
            p = p[:i] + ["norm", "weight" if leaf == "scale" else "bias"]
    elif leaf in ("reduction_weight", "reduction_bias"):
        p = p[:-1] + ["reduction_conv", "conv", "weight" if leaf == "reduction_weight" else
                      "bias"]
        if leaf == "reduction_weight":
            value = _oihw(value)
    elif any(q.startswith("block_") for q in p) and p[-2] in ("dwconv", "norm", "pwconv1",
                                                               "pwconv2", "grn"):
        mod = p[-2]
        if mod == "dwconv" and leaf == "kernel":
            p, value = p[:-1] + ["weight"], _oihw(value)
        elif mod == "norm":
            p = p[:-1] + ["weight" if leaf == "scale" else "bias"]
        elif mod.startswith("pwconv") and leaf == "kernel":
            p, value = p[:-1] + ["weight"], _t(value)
    elif len(p) >= 3 and p[-3:-1] == ["norm", "bn"]:
        p = p[:-3] + ["bn", _BN_LEAF[leaf]]
    elif len(p) >= 3 and re.fullmatch(r"input_proj_bn_\d+", p[-3]) and p[-2] == "bn":
        # RTDETRDecoder's input projection: Sequential(Conv2d, BatchNorm2d)
        p = p[:-3] + [p[-3].replace("input_proj_bn_", "input_proj_"), "1", _BN_LEAF[leaf]]
    elif re.fullmatch(r"norm\d+|enc_output_norm", p[-2]) and leaf == "scale":
        p = p[:-1] + ["weight"]  # a LayerNorm's
    elif leaf in ("denoising_class_embed", "tgt_embed"):
        p = p + ["weight"]  # an nn.Embedding's
    elif p[-2] in ("upsample", "conv_transpose") and leaf == "kernel":
        # flax ConvTranspose -> torch (in, out, kh, kw), the taps flipped
        p, value = p[:-1] + ["weight"], np.ascontiguousarray(
            value[::-1, ::-1].transpose(2, 3, 0, 1))
    elif p[-2:] == ["conv", "kernel"]:
        p, value = p[:-1] + ["weight"], _oihw(value)
    elif p[-2] == "gn":
        p = p[:-1] + ["weight" if leaf == "scale" else "bias"]
    elif leaf == "kernel":
        p, value = p[:-1] + ["weight"], _oihw(value) if value.ndim == 4 else _t(value)
    if len(p) == 3 and p[1] == "conv_transpose":  # a bare nn.ConvTranspose2d layer
        p = [p[0], p[2]]
    k = ".".join(p)
    # a repeated row's copies: the reference's Sequential children
    k = re.sub(r"^model_(\d+)_rep(\d+)\.", r"model_\1.\2.", k)
    # the reference's Segment and Pose inherit Detect: its towers are not nested
    k = re.sub(r"^(model_\d+)\.detect\.", r"\1.", k)
    k = re.sub(r"^model_(\d+)\.", r"model.\1.", k)
    k = re.sub(r"\b(cv2|cv3|cv4)_(\d+)_(\d+)\b", r"\1.\2.\3", k)
    k = re.sub(rf"\b({'|'.join(_INDEXED)})_(\d+)\.", r"\1.\2.", k)
    k = re.sub(r"\bconv_in\.", "conv.0.", k)
    k = re.sub(r"\bconv_out\.", "conv.4.", k)
    k = re.sub(r"\bblock_(\d+)\.", lambda m: f"conv.{int(m.group(1)) + 1}.", k)
    # RTDETRDecoder's module lists (`torch_import.translate_key` inverted)
    k = re.sub(r"\bdecoder_layer_(\d+)\.", r"decoder.layers.\1.", k)
    k = re.sub(r"\b(dec_score_head|dec_bbox_head)_(\d+)\.", r"\1.\2.", k)
    k = re.sub(r"\blayers_(\d+)\.", r"layers.\1.", k)
    k = re.sub(r"\binput_proj_(\d+)\.(weight|1\.)", lambda m: f"input_proj.{m.group(1)}."
               + ("0.weight" if m.group(2) == "weight" else "1."), k)
    k = k.replace("enc_output_dense.", "enc_output.0.").replace("enc_output_norm.", "enc_output.1.")
    return k, value


def _in_proj(variables: Mapping[str, np.ndarray], module: str, leaf: str
             ) -> Tuple[str, np.ndarray]:
    """An attention's q/k/v projections (`module`'s `q_proj`, `k_proj`,
    `v_proj`, flax `leaf` kernel or bias) packed as `nn.MultiheadAttention`
    keeps them, `in_proj_weight` (3 E, E) or `in_proj_bias` (3 E), checked
    to split back, as the import splits it (thirds), to the three flax
    values."""
    parts = [variables[f"params.{module}.{x}_proj.{leaf}"] for x in "qkv"]
    value = np.concatenate([_t(a) if leaf == "kernel" else a for a in parts])
    base = reference_key(f"params.{module}.out_proj.bias", parts[0])[0].rsplit(".", 2)[0]
    name = f"{base}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"
    ma_path = translate_key(f"{base}.out_proj.weight")[0][:-2]
    third = len(value) // 3
    for i, x in enumerate("qkv"):
        back = value[i * third:(i + 1) * third]
        back = _t(back) if leaf == "kernel" else back
        if ".".join(("params", *ma_path, f"{x}_proj", leaf)) != f"params.{module}.{x}_proj.{leaf}" \
                or not np.array_equal(back, parts[i]):
            raise KeyError(f"{name!r} does not split back to params.{module}.{x}_proj.{leaf}")
    return name, value


def reference_state(model: torch.nn.Module, params: Optional[Mapping] = None
                    ) -> "OrderedDict[str, np.ndarray]":
    """`model`'s state (with `params` replacing parameter values, as for an
    EMA) as the reference's float32 state dict, with what the reference
    keeps beside it that the import skips: BatchNorm's step counters, the
    DFL's fixed projection and the TOOD head's unused Scale modules. An
    attention's q/k/v projections are packed into `nn.MultiheadAttention`'s
    `in_proj_*` (`_in_proj`). Every name is checked to translate back
    (`translate_key`) to its flax path and its value."""
    out = OrderedDict()
    repeated = {s.i for s in model.specs if s.n > 1}
    variables = export_variables(model, params)
    for key, a in variables.items():
        qkv = re.fullmatch(r"params\.(.+)\.([qkv])_proj\.(kernel|bias)", key)
        if qkv and f"params.{qkv.group(1)}.out_proj.kernel" in variables:
            if qkv.group(2) == "q":
                name, value = _in_proj(variables, qkv.group(1), qkv.group(3))
                out[name] = value
            continue
        name, value = reference_key(key, a)
        m_rep = re.match(r"^model\.(\d+)\.(\d+)\.(.*)$", name)
        if int(name.split(".")[1]) in repeated and not m_rep:
            name = re.sub(r"^model\.(\d+)\.", r"model.\1.0.", name)  # the first copy
            m_rep = re.match(r"^model\.(\d+)\.(\d+)\.(.*)$", name)
        tr = translate_key(name)
        back_key = tr and ".".join((tr[2], *tr[0]))
        if m_rep:
            # the import's retry for a repeated row's copy R: model_N (R = 0) or model_N_repR
            n_, r_, rest = m_rep.groups()
            tr = translate_key(f"model.{n_}.{rest}")
            layer = f"model_{n_}" if r_ == "0" else f"model_{n_}_rep{r_}"
            back_key = tr and ".".join((tr[2], layer, *tr[0][1:]))
        elif back_key != key and tr and tr[0][0].startswith("model_"):
            # the import's retry one level down, under a Segment / Pose `detect`
            back_key = ".".join((tr[2], tr[0][0], "detect", *tr[0][1:]))
        if tr is None or back_key != key:
            raise KeyError(f"{key!r} was written as {name!r}, which reads back as {tr}")
        back = tr[1](value) if tr[1] else value
        if back.shape != a.shape or not np.array_equal(back, a):
            raise ValueError(f"{name!r} does not read back to the values of {key!r}")
        out[name] = value
        if name.endswith("running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = np.array(0, np.int64)
    head_i = model.specs[-1].i
    if getattr(model, "reg_max", 0) > 1:
        out[f"model.{head_i}.dfl.conv.weight"] = \
            np.arange(model.reg_max, dtype=np.float32).reshape(1, model.reg_max, 1, 1)
    if model.specs[-1].name == "TOODHead":
        for i in range(len(model.stride)):
            out[f"model.{head_i}.scale.{i}.scale"] = np.ones(1, np.float32)
    return out


class _Classes:
    """Module graph classes registered as importable modules for as long as
    the `with` block runs, then removed (what `sys.modules` held under their
    names before is put back): a file pickled inside holds classes that do
    not import afterwards."""

    def __init__(self):
        self.modules: Dict[str, types.ModuleType] = {}

    def get(self, module: str, name: str) -> type:
        mod = self.modules.get(module)
        if mod is None:
            mod = self.modules[module] = types.ModuleType(module)
        cls = getattr(mod, name, None)
        if cls is None:
            cls = type(name, (torch.nn.Module,), {"__module__": module, "__qualname__": name})
            setattr(mod, name, cls)
        return cls

    @contextlib.contextmanager
    def registered(self):
        names = set()
        for m in self.modules:
            parts = m.split(".")
            names.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
        held = {n: sys.modules[n] for n in names if n in sys.modules}
        for n in sorted(names):
            sys.modules[n] = self.modules.get(n) or types.ModuleType(n)
        try:
            yield
        finally:
            for n in names:
                sys.modules.pop(n, None)
            sys.modules.update(held)


def _transformer_node(classes: _Classes, path) -> type:
    """The class of the node at `path` inside an AIFI or RTDETRDecoder
    layer: the reference's own (`ultralytics.nn.modules.transformer`) or
    torch's (the attentions, linears, norms, lists, the projections'
    convolution and BatchNorm, the class embedding)."""
    name, parent, grand = path[-1], path[-2], path[-3]
    if name == "decoder":
        return classes.get(_TRANSFORMER, "DeformableTransformerDecoder")
    if parent == "layers" and grand == "decoder":
        return classes.get(_TRANSFORMER, "DeformableTransformerDecoderLayer")
    if name == "cross_attn":
        return classes.get(_TRANSFORMER, "MSDeformAttn")
    if name == "enc":  # AIFI's encoder layer, at the JAX package's nesting
        return classes.get(_TRANSFORMER, "TransformerEncoderLayer")
    if name in ("query_pos_head", "enc_bbox_head") or parent == "dec_bbox_head":
        return classes.get(_TRANSFORMER, "MLP")
    if name in ("self_attn", "ma"):
        return torch.nn.MultiheadAttention
    if name == "out_proj":
        return torch.nn.modules.linear.NonDynamicallyQuantizableLinear
    if name in ("layers", "input_proj", "dec_score_head", "dec_bbox_head"):
        return torch.nn.ModuleList
    if name == "enc_output" or parent == "input_proj":
        return torch.nn.Sequential
    if grand == "input_proj":
        return torch.nn.Conv2d if name == "0" else torch.nn.BatchNorm2d
    if re.fullmatch(r"norm\d+", name) or (parent == "enc_output" and name == "1"):
        return torch.nn.LayerNorm
    if name == "denoising_class_embed":
        return torch.nn.Embedding
    return torch.nn.Linear  # the feed-forwards, projections, heads and MLP layers


def _node_class(classes: _Classes, path, name: str, layer_types: Dict[str, str],
                repeated=frozenset()) -> type:
    """The class of the graph node at `path` (its attribute `name`)."""
    if len(path) > 2 and path[0] == "model" and \
            layer_types[path[1]] in ("AIFI", "RTDETRDecoder"):
        return _transformer_node(classes, path)
    if len(path) in (2, 3) and path[0] == "model":
        kind = layer_types[path[1]]
        if len(path) == 2 and path[1] in repeated:
            return torch.nn.Sequential
        if kind in _TORCH_LAYERS:
            return _TORCH_LAYERS[kind]
        if len(path) == 2 or path[1] in repeated:
            return classes.get(f"ultralytics.nn.modules.{_LAYER_MODULES.get(kind, 'block')}",
                               kind)
    if name == "DyDCNV2":
        return classes.get("ultralytics.nn.modules.block", "DyDCNv2")
    if len(path) >= 2 and path[-2] == "DyDCNV2" and name == "conv":
        return classes.get("mmcv.ops.modulated_deform_conv", "ModulatedDeformConv2d")
    return classes.get("ultralytics.nn.modules.block",
                       "".join(w.capitalize() for w in re.split(r"[_\d]+", name) if w) or "Seq")


def _new(cls: type) -> torch.nn.Module:
    """An empty instance of a module class: torch's own layers take
    constructor arguments, which the state set afterwards makes moot."""
    if cls.__module__.startswith("torch.nn") and cls not in (torch.nn.Upsample,
                                                             torch.nn.Sequential):
        obj = cls.__new__(cls)
        torch.nn.Module.__init__(obj)
        return obj
    return cls()


def _graph(classes: _Classes, state: Mapping[str, torch.Tensor], layer_types,
           attrs: Mapping, root_name: str = "DetectionModel",
           repeated=frozenset()) -> torch.nn.Module:
    """The reference's module graph holding `state` under its names: a
    `root_name` (`DetectionModel`, `ClassificationModel`) with `attrs`, its
    layers in a Sequential `model`, a repeated row's copies in a Sequential
    of their own."""
    root = classes.get("ultralytics.nn.tasks", root_name)()
    root.model = torch.nn.Sequential()
    for i in sorted(layer_types, key=int):
        root.model.add_module(i, _new(_node_class(classes, ("model", i), i, layer_types,
                                                  repeated)))
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = root
        for j, part in enumerate(path):
            child = node._modules.get(part)
            if child is None:
                child = _new(_node_class(classes, path[:j + 1], part, layer_types, repeated))
                node.add_module(part, child)
            node = child
        if leaf in ("running_mean", "running_var", "num_batches_tracked"):
            node.register_buffer(leaf, t)
        else:
            node.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    for k, v in attrs.items():
        setattr(root, k, v)
    return root


def write_reference_pt(model, path, model_params: Optional[Mapping] = None,
                       ema: bool = True, bare: bool = False) -> Path:
    """Write `model` as a reference checkpoint at `path`: `ema` and `model`
    graphs of its state in half precision (`model_params` replace the raw
    model's parameter values), `ema` None where `ema` is False, `train_args`
    with `model` (the model's YAML); with `bare`, the EMA's state dict
    alone."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def tensors(p):
        return OrderedDict((k, torch.from_numpy(np.asarray(v)).to(
            torch.float16 if np.asarray(v).dtype.kind == "f" else torch.int64))
            for k, v in reference_state(model, p).items())

    ema_state = tensors(None)
    if bare:
        torch.save(ema_state, str(path))
        return path
    cfg = load_config(model.model_yaml)
    cfg["nc"] = model.nc
    attrs = {"yaml": cfg, "nc": model.nc, "names": dict(model.names),
             "stride": torch.tensor([float(s) for s in model.stride]),
             "save": list(model.save), "args": {"model": model.model_yaml}}
    layer_types = {str(s.i): s.name for s in model.specs}
    repeated = frozenset(str(s.i) for s in model.specs if s.n > 1)
    root = "ClassificationModel" if model.task == "classify" else \
        "RTDETRDetectionModel" if model.specs[-1].name == "RTDETRDecoder" else "DetectionModel"
    classes = _Classes()
    raw = _graph(classes, tensors(model_params) if model_params is not None else ema_state,
                 layer_types, attrs, root, repeated)
    ema_graph = _graph(classes, ema_state, layer_types, attrs, root, repeated) if ema else None
    ckpt = {"epoch": -1, "best_fitness": None, "model": raw, "ema": ema_graph, "updates": 0,
            "optimizer": None,
            "train_args": {"model": model.model_yaml, "imgsz": 640},
            "date": "1970-01-01T00:00:00", "version": "8.0.0"}
    with classes.registered():
        torch.save(ckpt, str(path))
    return path
