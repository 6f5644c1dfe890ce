"""Automatic mask generation's helpers in numpy (point grids, crop boxes,
the stability score, uncompressed RLE, small-region cleanup, mask boxes),
the counterparts of `mgdt_yolo_tpu/vit/sam/amg.py`.

`remove_small_regions` labels 8-connected regions with
`scipy.ndimage.label` where JAX calls cv2's `connectedComponentsWithStats`,
and renumbers them in cv2 5's order: its block-based labelling numbers
regions by the first 2x2 block (in raster order of blocks) that holds one
of their pixels, not by their first pixel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) evenly spaced (x, y) points in [0, 1]^2, x fastest."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    px = np.tile(side[None, :], (n_per_side, 1))
    py = np.tile(side[:, None], (1, n_per_side))
    return np.stack([px, py], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    """One grid per crop layer, `scale_per_layer` times sparser each."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float) -> Tuple[List[List[int]], List[int]]:
    """xyxy crop boxes and their layers: the image, then (2^i)^2
    overlapping crops in layer i."""
    crop_boxes: List[List[int]] = [[0, 0, im_size[1], im_size[0]]]
    layer_idxs: List[int] = [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def calculate_stability_score(masks: np.ndarray, mask_threshold: float,
                              threshold_offset: float) -> np.ndarray:
    """The IoU of a mask's binarisations at threshold +- offset (logits
    (..., H, W))."""
    inter = (masks > (mask_threshold + threshold_offset)).sum(-1).sum(-1)
    union = (masks > (mask_threshold - threshold_offset)).sum(-1).sum(-1)
    return inter / np.maximum(union, 1)


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """(H, W) binary mask -> uncompressed column-major RLE, starting with a
    run of zeros."""
    h, w = mask.shape
    flat = mask.transpose().reshape(-1).astype(bool)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    counts = np.diff(np.concatenate([[0], change, [h * w]])).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """The inverse of `mask_to_rle`."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx, parity = 0, False
    for count in rle["counts"]:
        mask[idx:idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def label_regions(working: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected regions of a binary (H, W) image: (labels, count), in
    cv2 5's numbering (`connectedComponentsWithStats(img, 8)`): 0 the
    background, regions ordered by the first 2x2 block, in raster order of
    blocks, holding one of their pixels."""
    from scipy import ndimage
    lab, n = ndimage.label(working, structure=np.ones((3, 3), bool))
    if n < 2:
        return lab, n
    ys, xs = np.nonzero(lab)
    block = (ys // 2) * ((working.shape[1] + 1) // 2) + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, lab[ys, xs], block)
    renumber = np.zeros(n + 1, lab.dtype)
    renumber[np.argsort(first[1:], kind="stable") + 1] = np.arange(1, n + 1)
    return renumber[lab], n


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str
                         ) -> Tuple[np.ndarray, bool]:
    """Fill the holes (`mode="holes"`) or drop the islands (`"islands"`)
    under `area_thresh` pixels; with every island small, the largest stays.
    Returns (mask, whether it changed)."""
    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    regions, n = label_regions((correct_holes ^ mask).astype(np.uint8))
    sizes = np.bincount(regions.ravel(), minlength=n + 1)[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n + 1) if i not in fill] or [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(..., H, W) binary masks -> xyxy boxes, the max edges inclusive,
    zeros for an empty mask."""
    shape = masks.shape
    h, w = shape[-2:]
    flat = masks.reshape(-1, h, w)
    out = np.zeros((flat.shape[0], 4), np.float32)
    for i, m in enumerate(flat):
        ys, xs = np.nonzero(m)
        if len(xs):
            out[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return out.reshape(*shape[:-2], 4)


def is_box_near_crop_edge(boxes: np.ndarray, crop_box: List[int], orig_box: List[int],
                          atol: float = 20.0) -> np.ndarray:
    """Boxes within `atol` of a crop edge that is not an image edge."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol)
    near_image = np.isclose(boxes, orig[None], atol=atol)
    return (near_crop & ~near_image).any(-1)
