"""SAM state dicts: a reference (torch) SAM checkpoint loaded by name, and
the JAX package's flax variables carried onto the port; the counterpart of
`mgdt_yolo_tpu/vit/sam/weights.py`.

The port's SAM modules keep the reference's names, so `translate_sam_key`
maps a reference key to itself, except the mask-prompt tower
(`mask_downscaling.*`), which neither package builds, and BatchNorm
counters. `load_sam_state_dict` merges such a state dict non-strictly and
reports matched, name-missed and shape-missed keys as JAX's does.
`flax_path` is JAX's flax name of a reference key (a copy of JAX's
`translate_sam_key` renames) with its relayout, and `state_from_flax`
turns a JAX `Sam`'s variables into the port's state with the inverse
relayouts.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)

_SAM_SKIPS = (r"\bmask_downscaling\.", r"\.num_batches_tracked$")
_LN_SCALE = ("norm1", "norm2", "norm3", "norm4", "norm_final")
_LN2D = ("neck_ln1", "neck_ln2", "upscale_ln")
_EMBEDS = ("pos_embed", "rel_pos_h", "rel_pos_w", "pe_gaussian", "not_a_point_embed",
           "no_mask_embed", "iou_token", "mask_tokens")
_RENAMES = (
    ("patch_embed.proj.", "patch_embed."),
    ("pe_layer.positional_encoding_gaussian_matrix", "pe_gaussian"),
    ("not_a_point_embed.weight", "not_a_point_embed"),
    ("no_mask_embed.weight", "no_mask_embed"),
    ("iou_token.weight", "iou_token"),
    ("mask_tokens.weight", "mask_tokens"),
    ("neck.0.", "neck_conv1."), ("neck.1.", "neck_ln1."),
    ("neck.2.", "neck_conv2."), ("neck.3.", "neck_ln2."),
    ("mlp.lin1.", "mlp_lin1."), ("mlp.lin2.", "mlp_lin2."),
    ("cross_attn_token_to_image.", "cross_attn_t2i."),
    ("cross_attn_image_to_token.", "cross_attn_i2t."),
    ("final_attn_token_to_image.", "final_attn."),
    ("norm_final_attn.", "norm_final."),
    ("output_upscaling.0.", "upscale_conv1."),
    ("output_upscaling.1.", "upscale_ln."),
    ("output_upscaling.3.", "upscale_conv2."),
)


def translate_sam_key(tkey: str) -> Optional[str]:
    """The port's state-dict key of a reference SAM key (the same name), or
    None for a key the port does not build."""
    if any(re.search(p, tkey) for p in _SAM_SKIPS):
        return None
    return tkey


def flax_path(tkey: str) -> Optional[Tuple[Tuple[str, ...], str]]:
    """(JAX's flax path, relayout kind) of a reference SAM key, as JAX's
    `translate_sam_key` maps it; None where JAX skips the key."""
    if translate_sam_key(tkey) is None:
        return None
    k = re.sub(r"\bblocks\.(\d+)\.", r"blocks_\1.", tkey)
    k = re.sub(r"\blayers\.(\d+)\.", r"layers_\1.", k)
    k = re.sub(r"point_embeddings\.(\d+)\.weight", r"point_embed_\1", k)
    for a, b in _RENAMES:
        k = k.replace(a, b)
    k = re.sub(r"output_hypernetworks_mlps\.(\d+)\.layers_2\.", r"hyper_\1_out.", k)
    k = re.sub(r"output_hypernetworks_mlps\.(\d+)\.layers_(\d)\.", r"hyper_\1_lin\2.", k)
    k = re.sub(r"iou_prediction_head\.layers_2\.", "iou_head_out.", k)
    k = re.sub(r"iou_prediction_head\.layers_(\d)\.", r"iou_head_\1.", k)
    parts = k.split(".")
    leaf, mod = parts[-1], (parts[-2] if len(parts) > 1 else "")
    base = tuple(parts[:-1])
    if leaf in _EMBEDS or leaf.startswith("point_embed_"):
        return tuple(parts), "direct"
    if leaf == "bias":
        return base + ("bias",), "direct"
    if leaf != "weight":
        return None
    if mod in _LN2D:
        return base + ("weight",), "direct"
    if mod in _LN_SCALE:
        return base + ("scale",), "direct"
    if mod.startswith("upscale_conv"):
        return base + ("kernel",), "convT"
    if mod in ("patch_embed", "neck_conv1", "neck_conv2"):
        return base + ("kernel",), "conv"
    return base + ("kernel",), "linear"


# each flax layout back to torch's: the inverses of the reference-to-flax
# relayouts (`utils/torch_import.py` `_linear_w`, `_conv_w`, `_convT_w`;
# flax's ConvTranspose, with `transpose_kernel=False`, correlates: its taps
# are torch's flipped)
_TO_TORCH = {"direct": lambda a: a,
             "linear": lambda a: np.transpose(a, (1, 0)),
             "conv": lambda a: np.transpose(a, (3, 2, 0, 1)),
             "convT": lambda a: np.ascontiguousarray(np.transpose(a[::-1, ::-1], (2, 3, 0, 1)))}


def state_from_flax(model: torch.nn.Module, variables: Mapping) -> Dict[str, np.ndarray]:
    """The port's state dict (numpy, torch layouts) of a JAX `Sam`'s (or
    one of its modules') variables: every key of `model` read from its
    flax path. Raises KeyError naming a key JAX's tree lacks."""
    params = variables.get("params", variables)
    out = {}
    for key in model.state_dict():
        path, kind = flax_path(key)
        node = params
        for p in path:
            if p not in node:
                raise KeyError(f"{key}: no flax leaf {'/'.join(path)}")
            node = node[p]
        out[key] = _TO_TORCH[kind](np.asarray(node, np.float32))
    return out


def load_sam_state_dict(model: torch.nn.Module, state_dict: Mapping[str, np.ndarray],
                        verbose: bool = True) -> Dict:
    """Merge a reference SAM state dict into `model` in place, non-strictly:
    returns {"matched": n, "shape_missed": [(key, given, expected)],
    "name_missed": [key]}, as JAX's report counts them. A value with an
    extra leading axis of 1 lands squeezed, as in JAX."""
    own = model.state_dict()
    matched, shape_miss, name_miss = [], [], []
    with torch.no_grad():
        for tkey, arr in state_dict.items():
            key = translate_sam_key(tkey)
            if key is None:
                continue
            if key not in own:
                name_miss.append(tkey)
                continue
            val = torch.as_tensor(np.asarray(arr, np.float32))
            dst = own[key]
            if tuple(val.shape) != tuple(dst.shape):
                if val.ndim == dst.ndim + 1 and val.shape[0] == 1:
                    val = val[0]
                if tuple(val.shape) != tuple(dst.shape):
                    shape_miss.append((tkey, tuple(np.shape(arr)), tuple(dst.shape)))
                    continue
            dst.copy_(val.to(dst.dtype))
            matched.append(tkey)
    report = {"matched": len(matched), "shape_missed": shape_miss, "name_missed": name_miss}
    if verbose:
        LOGGER.info(f"SAM import: {len(matched)} matched, {len(shape_miss)} shape-missed, "
                    f"{len(name_miss)} name-missed")
        for k in name_miss[:10]:
            LOGGER.info(f"  unmatched: {k}")
    return report
