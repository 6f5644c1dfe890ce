"""Reference `.pt` checkpoints: the reference's state-dict names carried to
the port's modules, the counterpart of `mgdt_yolo_tpu/utils/torch_import.py`.

A reference checkpoint (`trainer.py:411-436` of the reference) pickles the
fork's whole `nn.Module` graph, in half precision, under `ema` and `model`,
with `train_args`. `load_torch_pt` unpickles it without the fork's or
mmcv's classes and walks the graph to a flat {name: float32 array} state
dict. `translate_key` maps one reference name to the flax path the JAX
package keeps it under, with the relayout (a copy of the JAX function),
and `weights.translate` carries that flax path on to the port's state-dict
key, so the port reads a reference name exactly as the JAX package does.
`load_torch_state_dict` merges such a state dict into a port model as the
JAX package merges it into its flax variables (non-strict: unmatched keys
are counted, not fatal) and returns the same report.
"""
from __future__ import annotations

import _compat_pickle
import dataclasses
import logging
import re
import sys
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..weights import TRANSPOSED, flax_keys, translate

LOGGER = logging.getLogger(__name__)


def _conv_w(a: np.ndarray) -> np.ndarray:
    """torch conv OIHW -> flax HWIO (works for depthwise too)."""
    return np.transpose(a, (2, 3, 1, 0))


def _linear_w(a: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) -> flax Dense (in, out)."""
    return np.transpose(a, (1, 0))


def _convT_w(a: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw) -> flax ConvTranspose
    (kh, kw, in, out) with the taps flipped spatially (flax correlates where
    torch's transposed convolution convolves)."""
    return np.transpose(a, (2, 3, 0, 1))[::-1, ::-1].copy()


def _reduction_w(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (2, 3, 1, 0))


def _plain_w(a: np.ndarray) -> np.ndarray:
    return _conv_w(a) if a.ndim == 4 else _linear_w(a)


# leaf names inside a Conv(+BN) block
_CONV_LEAVES = {
    "conv.weight": (("conv", "kernel"), _conv_w, "params"),
    "conv.bias": (("conv", "bias"), None, "params"),
    "bn.weight": (("norm", "bn", "scale"), None, "params"),
    "bn.bias": (("norm", "bn", "bias"), None, "params"),
    "bn.running_mean": (("norm", "bn", "mean"), None, "batch_stats"),
    "bn.running_var": (("norm", "bn", "var"), None, "batch_stats"),
}

_SKIP_PATTERNS = (
    r"\.dfl\.conv\.weight$",        # the DFL's fixed arange projection
    r"\.num_batches_tracked$",
    r"\.scale\.\d+\.scale$",        # TOODHead's unused Scale modules
    r"^model\.\d+\.anchors$",
    r"^model\.\d+\.strides$",
)


def translate_key(tkey: str) -> Optional[Tuple[Tuple[str, ...], Any, str]]:
    """One reference state-dict key -> (flax path, relayout or None,
    collection); None for a key that is skipped on purpose."""
    for pat in _SKIP_PATTERNS:
        if re.search(pat, tkey):
            return None
    k = tkey
    k = re.sub(r"^model\.(\d+)\.", r"model_\1.", k)
    # indexed module lists -> underscore names
    k = re.sub(r"\b(cv2|cv3|cv4)\.(\d+)\.(\d+)\.", r"\1_\2_\3.", k)   # head towers
    k = re.sub(r"\b(cv2|cv3|cv4)\.(\d+)\.(\d+)$", r"\1_\2_\3", k)
    k = re.sub(r"\bm\.(\d+)\.", r"m_\1.", k)                           # CSP bottlenecks
    k = re.sub(r"\btr\.(\d+)\.", r"tr_\1.", k)                         # TransformerBlock layers
    # the RT-DETR decoder head
    k = re.sub(r"\bdecoder\.layers\.(\d+)\.", r"decoder_layer_\1.", k)
    k = re.sub(r"\binput_proj\.(\d+)\.0\.", r"input_proj_\1.", k)
    m_ipbn = re.search(r"\binput_proj\.(\d+)\.1\.(\w+)$", k)
    if m_ipbn:  # input_proj's BatchNorm (Sequential slot 1)
        base = tuple(k[:m_ipbn.start()].rstrip(".").split(".")) if m_ipbn.start() else ()
        base = base + (f"input_proj_bn_{m_ipbn.group(1)}", "bn")
        lut = {"weight": ("scale", "params"), "bias": ("bias", "params"),
               "running_mean": ("mean", "batch_stats"), "running_var": ("var", "batch_stats")}
        if m_ipbn.group(2) in lut:
            name, coll = lut[m_ipbn.group(2)]
            return base + (name,), None, coll
        return None
    k = re.sub(r"\b(dec_bbox_head|dec_score_head)\.(\d+)\.", r"\1_\2.", k)
    k = re.sub(r"\blayers\.(\d+)\.", r"layers_\1.", k)                 # MLP towers
    k = k.replace("enc_output.0.", "enc_output_dense.")
    k = k.replace("enc_output.1.", "enc_output_norm.")
    if k.endswith("denoising_class_embed.weight") or k.endswith("tgt_embed.weight"):
        return tuple(k.split(".")[:-1]), None, "params"
    k = re.sub(r"\bconvs\.(\d+)\.", r"convs_\1.", k)                   # MSPA convs
    k = re.sub(r"\bbottleneck\.(\d+)\.", r"bottleneck_\1.", k)         # MSPA bottlenecks
    k = re.sub(r"\bshare_conv\.(\d+)\.", r"share_conv_\1.", k)         # TOOD tower
    # IFM's Sequential: conv.0 -> conv_in, conv.1..3 -> block_0..2, conv.4 -> conv_out
    m = re.search(r"\bconv\.(\d+)\.", k)
    if m and ("block_" not in k):
        idx = int(m.group(1))
        if idx == 0:
            k = k.replace(f"conv.{idx}.", "conv_in.", 1)
        elif idx == 4:
            k = k.replace(f"conv.{idx}.", "conv_out.", 1)
        else:
            k = k.replace(f"conv.{idx}.", f"block_{idx - 1}.", 1)

    parts = k.split(".")
    tail2 = ".".join(parts[-2:])
    head = parts[:-2]

    # ConvTranspose2d weights (Proto.upsample, ConvTranspose.conv_transpose)
    if tail2 in ("upsample.weight", "conv_transpose.weight"):
        return tuple(head) + (parts[-2], "kernel"), _convT_w, "params"
    if tail2 in ("upsample.bias", "conv_transpose.bias"):
        return tuple(head) + (parts[-2], "bias"), None, "params"
    # a bare nn.ConvTranspose2d graph layer (the v6 head): model.11.weight/bias
    if re.fullmatch(r"model_\d+\.(weight|bias)", k):
        if parts[-1] == "weight":
            return (parts[0], "conv_transpose", "kernel"), _convT_w, "params"
        return (parts[0], "conv_transpose", "bias"), None, "params"

    # TaskDecomposition's reduction conv
    if "reduction_conv" in parts:
        base = tuple(parts[:parts.index("reduction_conv")])
        if tail2 == "conv.weight":
            return base + ("reduction_weight",), _reduction_w, "params"
        if tail2 == "conv.bias":
            return base + ("reduction_bias",), None, "params"

    # DyDCNv2: conv.weight -> weight (HWIO); norm -> gn
    if "DyDCNV2" in parts or "DyDCNv2" in parts:
        i = [p for p in ("DyDCNV2", "DyDCNv2") if p in parts][0]
        base = tuple(parts[:parts.index(i) + 1])
        if tail2 == "conv.weight":
            return base + ("weight",), _conv_w, "params"
        if tail2 == "conv.bias":
            return base + ("bias",), None, "params"
        if tail2 == "norm.weight":
            return base + ("gn", "scale"), None, "params"
        if tail2 == "norm.bias":
            return base + ("gn", "bias"), None, "params"

    # ConvNeXtV2 internals
    if any(p.startswith("block_") for p in parts) or "grn" in parts:
        base, leaf, mod = tuple(parts[:-2]), parts[-1], parts[-2]
        if mod == "dwconv":
            return base + ("dwconv", "kernel" if leaf == "weight" else "bias"), \
                (_conv_w if leaf == "weight" else None), "params"
        if mod == "norm":
            return base + ("norm", "scale" if leaf == "weight" else "bias"), None, "params"
        if mod in ("pwconv1", "pwconv2"):
            return base + (mod, "kernel" if leaf == "weight" else "bias"), \
                (_linear_w if leaf == "weight" else None), "params"
        if mod == "grn":
            return base + ("grn", leaf), None, "params"

    # RepVGGBlock's identity branch: a bare BatchNorm2d
    if "rbr_identity" in parts:
        base = tuple(parts[:parts.index("rbr_identity") + 1])
        leaf = parts[-1]
        mapping = {"weight": ("bn", "scale"), "bias": ("bn", "bias"),
                   "running_mean": ("bn", "mean"), "running_var": ("bn", "var")}
        if leaf in mapping:
            coll = "batch_stats" if leaf.startswith("running") else "params"
            return base + mapping[leaf], None, coll

    # Conv(+BN) leaves
    if tail2 in _CONV_LEAVES:
        path, tf, coll = _CONV_LEAVES[tail2]
        return tuple(head) + path, tf, coll

    # GroupNorm blocks (Conv_GN)
    if tail2 in ("gn.weight", "gn.bias"):
        return tuple(head) + ("gn", "scale" if parts[-1] == "weight" else "bias"), None, "params"

    # plain nn.LayerNorm leaves (RT-DETR's norm1..3, AIFI, enc_output_norm)
    if len(parts) >= 2 and parts[-1] in ("weight", "bias") and (
            re.fullmatch(r"norm\d+", parts[-2]) or parts[-2] == "enc_output_norm"):
        return tuple(parts[:-1]) + ("scale" if parts[-1] == "weight" else "bias",), \
            None, "params"

    # plain conv2d / linear leaves (head 1x1s, SPR fc, la_conv, offset convs)
    leaf, base = parts[-1], tuple(parts[:-1])
    if leaf == "weight":
        return base + ("kernel",), _plain_w, "params"
    if leaf == "bias":
        return base + ("bias",), None, "params"
    return None


def flax_shapes(model: torch.nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """{flat flax key: (the port's state-dict name, the shape flax keeps it
    in)} for every parameter and statistic of `model`."""
    state = model.state_dict()
    out = {}
    for name, key in flax_keys(model).items():
        shape = tuple(state[name].shape)
        if key.endswith(tuple(f".{m}.kernel" for m in TRANSPOSED)):
            shape = (shape[2], shape[3], shape[0], shape[1])  # (in, out, kh, kw)
        elif key.endswith(".kernel"):
            shape = (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape[::-1]
        out[key] = (name, shape)
    return out


def load_torch_state_dict(model: torch.nn.Module, state_dict: Mapping[str, np.ndarray],
                          verbose: bool = True) -> Dict:
    """Merge a reference state dict into `model` in place, non-strict, as
    the JAX `load_torch_state_dict` merges it into flax variables: each key
    through `translate_key` (with its retries one level down under `detect`
    and into the `model_N_repR` copies of a repeated block), then through
    `weights.translate` onto the port's parameter. Returns the JAX report:
    {"matched": n, "shape_missed": [(key, shape, model's shape)],
    "name_missed": [key]}, the shapes in flax's layouts."""
    dst = flax_shapes(model)
    prefixes = {".".join(k.split(".")[:i]) for k in dst for i in range(2, k.count(".") + 1)}

    def lookup(coll, path):
        """The shape at a flax path: a leaf's, () for a module (as numpy
        gives a dict's shape), None where there is nothing."""
        key = ".".join((coll, *path))
        if key in dst:
            return dst[key][1]
        return () if key in prefixes else None

    values, matched, shape_miss, name_miss = {}, [], [], []
    for tkey, arr in state_dict.items():
        arr = np.asarray(arr)
        # nn.MultiheadAttention packs q, k and v into in_proj_*: thirds
        if tkey.endswith(("in_proj_weight", "in_proj_bias")):
            anchor = translate_key(tkey.rsplit(".", 1)[0] + ".out_proj.weight")
            if anchor is not None:
                ma_path, third = anchor[0][:-2], arr.shape[0] // 3
                is_w = tkey.endswith("weight")
                ok_all = True
                for i, nm in enumerate(("q_proj", "k_proj", "v_proj")):
                    part = arr[i * third:(i + 1) * third]
                    val = _linear_w(part) if is_w else part
                    path = ma_path + (nm, "kernel" if is_w else "bias")
                    if lookup("params", path) != tuple(val.shape):
                        ok_all = False  # the thirds set before it stay set, as in JAX
                        break
                    values[".".join(("params", *path))] = val
                (matched if ok_all else name_miss).append(tkey)
                continue
        tr = translate_key(tkey)
        if tr is None:
            continue
        path, tf, coll = tr
        shape = lookup(coll, path)
        if shape is None and path and path[0].startswith("model_"):
            # Segment/Pose heads nest their Detect tower under `detect`
            alt = (path[0], "detect") + path[1:]
            if lookup(coll, alt) is not None:
                path, shape = alt, lookup(coll, alt)
        if shape is None:
            # repeated blocks: the reference's Sequential child model.N.R.*
            # -> model_N (R = 0) / model_N_repR (R > 0)
            m_rep = re.match(r"^model\.(\d+)\.(\d+)\.(.*)$", tkey)
            if m_rep:
                n_, r_, rest = m_rep.group(1), int(m_rep.group(2)), m_rep.group(3)
                alt_tr = translate_key(f"model.{n_}.{rest}")
                if alt_tr is not None:
                    alt_path, tf, coll = alt_tr
                    if r_ > 0:
                        alt_path = (f"model_{n_}_rep{r_}",) + alt_path[1:]
                    if lookup(coll, alt_path) is not None:
                        path, shape = alt_path, lookup(coll, alt_path)
        if shape is None:
            name_miss.append(tkey)
            continue
        val = tf(arr) if tf else arr
        if shape != tuple(val.shape):
            # a ConvTranspose2d weight that reached the plain conv rule
            if arr.ndim == 4 and shape == tuple(_convT_w(arr).shape):
                val = _convT_w(arr)
            else:
                shape_miss.append((tkey, tuple(val.shape), shape))
                continue
        key = ".".join((coll, *path))
        if key not in dst:
            raise ValueError(f"{tkey!r} fits the module {key!r} of the model, not a tensor")
        values[key] = val
        matched.append(tkey)
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for key, val in values.items():
            name, t = translate(key, val)
            if name != dst[key][0]:
                raise KeyError(f"{key!r} translates to {name!r}, not {dst[key][0]!r}")
            (params.get(name) if name in params else buffers[name]).copy_(t)
    report = {"matched": len(matched), "shape_missed": shape_miss, "name_missed": name_miss}
    if verbose:
        LOGGER.info(f"torch import: {len(matched)} matched, {len(shape_miss)} shape-missed, "
                    f"{len(name_miss)} name-missed")
        for k in name_miss[:10]:
            LOGGER.info(f"  unmatched: {k}")
    return report


class _Stub:
    """What a global of the pickle outside `_SAFE_GLOBALS` becomes (the
    fork's and mmcv's classes, and any function): calling it makes a stub,
    and its state lands in `__dict__`."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


# The globals a reference checkpoint's pickle may resolve to themselves:
# torch's tensor and parameter rebuilders, containers and numpy's array
# reconstructors. Beside these: torch's dtypes and storage types and the
# `torch.nn` module classes (`_safe_global`). torch.load's own wrapper
# resolves the typed storages before the shim sees them.
_SAFE_GLOBALS = frozenset({
    "collections.OrderedDict", "_codecs.encode",
    "builtins.set", "builtins.frozenset", "builtins.complex", "builtins.bytearray",
    "builtins.slice",
    "torch._utils._rebuild_tensor", "torch._utils._rebuild_tensor_v2",
    "torch._utils._rebuild_tensor_v3", "torch._utils._rebuild_parameter",
    "torch._utils._rebuild_parameter_with_state", "torch._tensor._rebuild_from_type_v2",
    "torch.Tensor", "torch.Size", "torch.device", "torch.nn.parameter.Parameter",
    "torch.storage.UntypedStorage", "torch.storage.TypedStorage",
    "numpy._core.multiarray._reconstruct", "numpy._core.multiarray.scalar",
    "numpy.core.multiarray._reconstruct", "numpy.core.multiarray.scalar",
    "numpy.ndarray", "numpy.dtype",
})


def _safe_global(find_class, module: str, name: str):
    """`find_class(module, name)` where the checkpoint may use that global
    (`_SAFE_GLOBALS`, a torch dtype or storage type, a class of
    `torch.nn.modules`), else None. Nothing else is imported or looked up."""
    module, name = _compat_pickle.NAME_MAPPING.get(
        (module, name), (_compat_pickle.IMPORT_MAPPING.get(module, module), name))
    if module.startswith("numpy.core.") and "numpy._core" in sys.modules:
        module = "numpy._core." + module[len("numpy.core."):]
    if "." in name:
        return None
    if f"{module}.{name}" in _SAFE_GLOBALS:
        return find_class(module, name)
    if module == "torch":
        obj = getattr(torch, name, None)
        if isinstance(obj, torch.dtype) or (isinstance(obj, type) and name.endswith("Storage")):
            return obj
    elif module.startswith("torch.nn.modules.") and module in sys.modules:
        obj = getattr(sys.modules[module], name, None)
        if isinstance(obj, type) and issubclass(obj, torch.nn.Module):
            return obj
    return None


def _pickle_shim():
    """A pickle module for `torch.load` whose Unpickler resolves only the
    globals `_safe_global` allows and makes a `_Stub` subclass of every
    other: the fork's and mmcv's classes, which do not import, and any
    function a file names, which is never returned, so reading a file runs
    none of its code."""
    import pickle

    class ForgivingUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            obj = _safe_global(super().find_class, module, name)
            if obj is None:
                return type(name, (_Stub,), {"__module__": module})
            return obj

    def load(f, **kw):
        return ForgivingUnpickler(f, **{k: v for k, v in kw.items()
                                        if k in ("fix_imports", "encoding", "errors")}).load()

    return type("shim", (), {"Unpickler": ForgivingUnpickler, "load": staticmethod(load)})


@dataclasses.dataclass
class PtCheckpoint:
    """A reference `.pt` as `read_torch_pt` reads it."""
    ckpt: Any                        # what the pickle holds
    state_dict: Dict[str, np.ndarray]
    train_args: Dict[str, Any]
    nc: Optional[int]                # the pickled model's class count, where it has one
    names: Optional[Dict[int, str]]  # and its class names


def _state_of(model_obj) -> Dict[str, np.ndarray]:
    """The flat float32 state of a pickled model: its own `state_dict` where
    its class imported, a walk of `_parameters`, `_buffers` and `_modules`
    where it is a stub, or the tensors of a bare state dict."""
    flat: Dict[str, np.ndarray] = {}

    def walk(obj, prefix=""):
        d = getattr(obj, "__dict__", None)
        if d is None:
            return
        for coll in ("_parameters", "_buffers"):
            for k, v in (d.get(coll) or {}).items():
                if v is not None and hasattr(v, "numpy"):
                    flat[prefix + k] = v.detach().float().numpy() \
                        if hasattr(v, "detach") else np.asarray(v)
        for k, child in (d.get("_modules") or {}).items():
            if child is not None:
                walk(child, prefix + k + ".")

    if hasattr(model_obj, "state_dict") and not isinstance(model_obj, dict) \
            and callable(getattr(model_obj, "state_dict", None)):
        try:
            return {k: v.detach().float().numpy() for k, v in model_obj.state_dict().items()}
        except Exception:
            walk(model_obj)
    elif isinstance(model_obj, dict):
        return {k: np.asarray(v.float() if hasattr(v, "float") else v)
                for k, v in model_obj.items() if hasattr(v, "shape")}
    else:
        walk(model_obj)
    return flat


def read_torch_pt(path) -> PtCheckpoint:
    """Unpickle a reference `.pt` (its classes need not import; torch's
    `weights_only` loading is off for it) and take the EMA model where
    there is one, else `model`, else the file itself (a bare state dict)."""
    ckpt = torch.load(str(path), map_location="cpu", pickle_module=_pickle_shim(),
                      weights_only=False)
    train_args: Dict[str, Any] = {}
    if isinstance(ckpt, dict):
        model_obj = ckpt.get("ema") or ckpt.get("model") or ckpt
        train_args = dict(ckpt.get("train_args") or {})
    else:
        model_obj = ckpt
    nc, names = None, None
    if not isinstance(model_obj, dict):
        yaml = getattr(model_obj, "yaml", None)
        nc = getattr(model_obj, "nc", None) or (yaml.get("nc") if isinstance(yaml, dict)
                                                 else None)
        names = getattr(model_obj, "names", None)
        if isinstance(names, (list, tuple)):
            names = dict(enumerate(names))
        names = {int(k): str(v) for k, v in names.items()} if isinstance(names, dict) else None
    return PtCheckpoint(ckpt, _state_of(model_obj), train_args,
                        int(nc) if nc else None, names)


def load_torch_pt(path) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(flat float32 state dict, train_args) of a reference `.pt`, as the
    JAX `load_torch_pt` returns them."""
    pt = read_torch_pt(path)
    return pt.state_dict, pt.train_args
