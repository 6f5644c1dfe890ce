"""Carry JAX (flax) variables across into the port's modules.

The port's modules carry the flax module names, so a flax path maps to a
state-dict key one to one: the collection prefix (`params.`,
`batch_stats.`) goes, the leaf is renamed, and the array is relaid:

* conv `kernel` HWIO -> `weight` OIHW (depthwise (7,7,1,C) -> (C,1,7,7));
* a transposed conv's (`Proto`'s `upsample`, a `ConvTranspose` layer's
  `conv_transpose`, a `DWConvTranspose2d` layer's own kernel, which sits
  directly on the graph layer) `kernel` (kh, kw, in, out or out / groups)
  -> ConvTranspose2d `weight` (in, out [/ groups], kh, kw) with both
  spatial axes flipped (flax's `ConvTranspose` and JAX's grouped
  `lax.conv_transpose` correlate where torch's convolves);
* Dense `kernel` (in, out) -> Linear `weight` (out, in) (the transformer
  layers' and RT-DETR's projections, MLPs and heads);
* BatchNorm/GroupNorm/LayerNorm `scale` -> `weight`, `bias` -> `bias`,
  batch_stats `mean`/`var` -> `running_mean`/`running_var`;
* everything else (the DCN's HWIO `weight`, TaskDecomposition's
  `reduction_weight`/`reduction_bias`, GRN's `gamma`/`beta`, RT-DETR's
  `denoising_class_embed`) as it is.

A row repeated on a non-CSP module is an `nn.Sequential` in the port and
`n` flax modules `model_i`, `model_i_rep1`, ... in JAX: `model_i_repR` is
the Sequential's child `model_i.R`, and `model_i` its child `model_i.0`
where layer i is such a row (`repeated`).

`flax_keys` and `save_npz` go the other way: a model's state (optionally
with other parameter values, such as an EMA) back to the flat flax-keyed
npz the JAX package reads, with `<stem>_metadata.json` beside it.
"""
from __future__ import annotations

import json
import re
from collections import OrderedDict
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
COLLECTIONS = ("params", "batch_stats")
_NORMS = (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)
# the flax names of the transposed convs (the mask prototypes' upsampling,
# a bare `nn.ConvTranspose2d` graph layer)
TRANSPOSED = ("upsample", "conv_transpose")
_REP = re.compile(r"^model_(\d+)_rep(\d+)$")
_LAYER = re.compile(r"^model_\d+(_rep\d+)?$")


def is_transposed_kernel(flax_key: str) -> bool:
    """Whether a flat flax key names a transposed conv's kernel: under a
    `TRANSPOSED` module, or directly on a graph layer (`DWConvTranspose2d`,
    the only layer whose kernel is its own)."""
    mods = flax_key.split(".")[1:-1]
    return bool(mods) and flax_key.endswith(".kernel") and (
        mods[-1] in TRANSPOSED or (len(mods) == 1 and bool(_LAYER.match(mods[0]))))


def flatten_variables(tree: Mapping, prefix: str = "") -> dict:
    """Nested flax variables -> {"params.a.b.kernel": array, ...}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, key + "."))
        else:
            flat[key] = v
    return flat


def repeated_layers(flax_keys_) -> frozenset:
    """The layer names (`model_i`) whose row repeats, as flax keys show them
    (a `model_i_repR` copy)."""
    out = set()
    for key in flax_keys_:
        m = _REP.match(key.split(".")[1] if "." in key else "")
        if m:
            out.add(f"model_{m.group(1)}")
    return frozenset(out)


def translate(key: str, value, repeated=frozenset()) -> tuple:
    """One flat flax key and array -> (state-dict key, float32 tensor);
    `repeated` names the layers whose rows repeat (`repeated_layers`)."""
    coll, _, path = key.partition(".")
    if coll not in COLLECTIONS or not path:
        raise KeyError(f"not a flax variable path: {key!r}")
    *mods, leaf = path.split(".")
    rep = _REP.match(mods[0]) if mods else None
    if rep:
        mods = [f"model_{rep.group(1)}", rep.group(2), *mods[1:]]
    elif mods and mods[0] in repeated:
        mods = [mods[0], "0", *mods[1:]]
    a = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        if a.ndim == 4 and is_transposed_kernel(key):
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"{key}: kernel of rank {a.ndim}")
        leaf = "weight"
    else:
        leaf = _LEAF.get(leaf, leaf)
    return ".".join([*mods, leaf]), torch.from_numpy(np.ascontiguousarray(a))


def load_jax_variables(flat_or_tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Flat `{"params.model_0.conv.kernel": array}` mapping (an npz) or a
    nested `{"params": ..., "batch_stats": ...}` tree -> a state dict."""
    keys = list(flat_or_tree.keys())
    if all(k in COLLECTIONS for k in keys):
        flat = flatten_variables(flat_or_tree)
    else:
        flat = {k: flat_or_tree[k] for k in keys}
    state = OrderedDict()
    repeated = repeated_layers(flat)
    for key, value in flat.items():
        name, t = translate(key, value, repeated)
        if name in state:
            raise KeyError(f"two flax paths map to {name!r}")
        state[name] = t
    return state


def load_state(module: torch.nn.Module, state: Mapping) -> None:
    """Load a translated state strictly: every key must land, and every
    parameter and buffer but BatchNorm's step counters must be filled."""
    result = module.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"weights do not fit the module: missing {missing[:8]}, "
                       f"unexpected {result.unexpected_keys[:8]}")


def read_metadata(path) -> dict:
    """`<stem>_metadata.json` beside an npz, or {} where there is none."""
    path = Path(path)
    meta = path.parent / f"{path.stem}_metadata.json"
    return json.loads(meta.read_text()) if meta.is_file() else {}


def read_semantics(path) -> str | None:
    """`deform_semantics` from `<stem>_metadata.json` beside an npz."""
    sem = read_metadata(path).get("deform_semantics")
    return sem if sem in ("windowed", "exact") else None


def load_npz(model, path) -> None:
    """Fill a DetectionModel from an exported flax npz and pin its deform
    semantics from the metadata beside it."""
    with np.load(str(path)) as flat:
        state = load_jax_variables({k: flat[k] for k in flat.files})
    load_state(model, state)
    sem = read_semantics(path)
    if sem:
        model.set_deform_semantics(sem)


def flax_keys(module: nn.Module) -> "OrderedDict[str, str]":
    """{state-dict key: flat flax key} for every parameter and statistic of
    a module (BatchNorm's step counters have none): the inverse of
    `translate`'s naming."""
    keys = OrderedDict()
    seq = {n for n, m in module.named_children() if isinstance(m, nn.Sequential)}
    for prefix, mod in module.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + \
            list(mod.named_buffers(recurse=False))
        for leaf, _ in tensors:
            if leaf == "num_batches_tracked":
                continue
            coll, flax_leaf = "params", leaf
            if leaf == "weight" and isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                flax_leaf = "kernel"
            elif leaf == "weight" and isinstance(mod, _NORMS):
                flax_leaf = "scale"
            elif leaf in ("running_mean", "running_var"):
                coll, flax_leaf = "batch_stats", leaf[len("running_"):]
            name = f"{prefix}.{leaf}" if prefix else leaf
            mods = prefix.split(".") if prefix else []
            if mods and mods[0] in seq:  # a repeated row: model_i.R -> model_i_repR
                mods = [mods[0] if mods[1] == "0" else f"{mods[0]}_rep{mods[1]}", *mods[2:]]
            keys[name] = ".".join([coll, *mods, flax_leaf])
    return keys


def export_variables(module: nn.Module, params: Mapping | None = None) -> dict:
    """A module's state as {flat flax key: float32 array} in flax layouts.
    `params` ({state-dict key: tensor}) replaces parameter values, e.g. an
    EMA of them."""
    state = module.state_dict()
    if params:
        state.update(params)
    return {key: to_flax_layout(key, state[name]) for name, key in flax_keys(module).items()}


def to_flax_layout(key: str, t: torch.Tensor) -> np.ndarray:
    """A port tensor as the float32 array flax keeps under `key` (conv
    kernels OIHW -> HWIO, transposed ones (in, out, kh, kw) -> (kh, kw, in,
    out) flipped, Dense kernels (out, in) -> (in, out))."""
    a = t.detach().float().cpu().numpy()
    if a.ndim == 4 and is_transposed_kernel(key):
        a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
    elif key.endswith(".kernel"):
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return np.ascontiguousarray(a)


def save_npz(module: nn.Module, path, metadata: Mapping,
             params: Mapping | None = None) -> Path:
    """Write `path` (.npz, flat flax keys) and `<stem>_metadata.json`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path), **export_variables(module, params))
    (path.parent / f"{path.stem}_metadata.json").write_text(
        json.dumps(dict(metadata), indent=1))
    return path
