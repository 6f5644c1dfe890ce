"""SAM in the port (`mgdt_yolo_tpu_torch/vit/sam/`) against the JAX package's
on the CPU, float32 on both sides, on inputs made with numpy from a seed.

JAX's variables come from its shape-only init filled with seeded values
(the relative-position and absolute position tables too, which JAX
initialises to 0, so the bias path is exercised) and are carried onto the
port by `weights.state_from_flax`. Tolerances, each with its reason:

* modules at tiny widths (D 32, depth 2, 2 heads): 1e-4 absolute, the
  outputs being of magnitude ~1-10: float32 sums in another order (XLA's
  einsums against PyTorch's matmuls), ~1e-6 observed;
* the facade (`_prep`, `predict`, `_postprocess_masks`): each pixel's
  logit within 1e-4 (the masks' resizes are cv2's float32 arithmetic on
  both sides), the binarised masks equal except where JAX's logit is
  within 1e-4 of the threshold, the predicted IoUs within 1e-4;
* `generate`: the kept masks, their order, areas, boxes and stability
  scores equal JAX's, the predicted IoUs within 1e-4; the thresholds are
  set in gaps of JAX's values, and the test asserts that no predicted IoU
  or stability score lies within 1e-4 of them;
* `amg.py`: exact (numpy on both sides; the region labels are cv2's);
* the key map: 0 name-missed and 0 shape-missed keys in both packages for
  a full `sam_b` state dict, then both decodes within 1e-4; JAX's loaded
  tree carried back, and each relayout undone, exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.vit.sam import amg as jax_amg
from mgdt_yolo_tpu.vit.sam import model as jax_model
from mgdt_yolo_tpu.vit.sam import modules as JM
from mgdt_yolo_tpu.vit.sam.weights import load_sam_state_dict as jax_load_sam_state_dict
from mgdt_yolo_tpu_torch.vit.sam import SAM, Sam, amg
from mgdt_yolo_tpu_torch.vit.sam import model as port_model
from mgdt_yolo_tpu_torch.vit.sam import modules as PM
from mgdt_yolo_tpu_torch.utils.torch_import import _conv_w, _convT_w, _linear_w
from mgdt_yolo_tpu_torch.vit.sam.weights import (flax_path, load_sam_state_dict,
                                                  state_from_flax, translate_sam_key)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
D = 32
TINY = (D, 2, 2, (1,))  # the facade's tiny arch: width, depth, heads, global blocks


def fill_flax(module, *args, seed=0, logit_gain=1.0, **kw):
    """JAX's variables of `module` from its shape-only init, filled with
    seeded values: kernels uniform by fan-in, norm scales near 1, biases,
    embeddings and the position tables random; the hypernetworks' output
    kernels times `logit_gain` (mask logits of a few units, so binarised
    masks are far from rounding ties)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        names = [p.key for p in path]
        name, shape = names[-1], sds.shape
        if name == "kernel":
            fan = int(np.prod(shape[:-1]))
            gain = logit_gain if names[-2].startswith("hyper_") and names[-2].endswith("_out") \
                else 1.0
            return (rng.uniform(-1, 1, shape) * gain / np.sqrt(fan)).astype(np.float32)
        if name in ("scale", "weight"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "pe_gaussian":
            return rng.standard_normal(shape).astype(np.float32)
        if name.startswith("rel_pos") or name == "pos_embed":
            return (0.05 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def carry(port_module, variables):
    """The port module with JAX's variables, every key loaded."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in state_from_flax(port_module, variables).items()}
    port_module.load_state_dict(sd, strict=True)
    return port_module.eval()


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= atol, f"{what}: max |diff| {err:.3e}"


# ---- modules ---------------------------------------------------------------
@pytest.mark.parametrize("img,window", [(64, 14), (80, 3)], ids=["pad_to_window", "3x3_windows"])
def test_image_encoder_matches_jax(img, window):
    """The encoder at D 32, depth 2, 2 heads, one global block: a 4x4 grid
    in one padded 14-window, and a 5x5 grid in 3-windows (padded to 6)."""
    kw = dict(img_size=img, patch_size=16, embed_dim=D, depth=2, num_heads=2, out_chans=16,
              window_size=window, global_attn_indexes=(1,))
    x = np.random.default_rng(1).uniform(-2, 2, (2, img, img, 3)).astype(np.float32)
    jm = JM.ImageEncoderViT(**kw)
    variables = fill_flax(jm, jnp.asarray(x), seed=2)
    want = np.asarray(jm.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    pm = carry(PM.ImageEncoderViT(**kw), variables)
    with torch.no_grad():
        got = pm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert np.abs(want).max() > 0.5
    _close(_np(got), want, "image embedding")


def test_get_rel_pos_resize_branch():
    """A table of another length is resized by JAX's linspace recipe; the
    table's own length needs no resize."""
    table = np.random.default_rng(3).standard_normal((7, 5)).astype(np.float32)
    for q, k in ((6, 6), (4, 4), (3, 6)):
        want = np.asarray(JM._get_rel_pos(q, k, jnp.asarray(table)))
        got = PM.get_rel_pos(q, k, torch.from_numpy(table))
        _close(_np(got), want, f"rel pos {q}x{k}", atol=1e-6)


def _prompt(points, boxes, seed=4):
    rng = np.random.default_rng(seed)
    pts = lab = bx = None
    if points:
        pts = rng.uniform(0, 64, (2, 3, 2)).astype(np.float32)
        lab = np.array([[1, 0, 1], [0, -1, 1]], np.int32)
    if boxes:
        xy = rng.uniform(0, 40, (2, 2, 2))
        bx = np.concatenate([xy, xy + rng.uniform(4, 20, (2, 2, 2))], -1).astype(np.float32)
    return pts, lab, bx


@pytest.mark.parametrize("points,boxes", [(True, False), (True, True), (False, True)],
                         ids=["points", "points_and_boxes", "boxes"])
def test_prompt_encoder_matches_jax(points, boxes):
    """Sparse and dense prompts and the dense positional encoding (the
    padding point of label -1 only without boxes)."""
    kw = dict(embed_dim=D, image_embedding_size=(4, 5), input_image_size=(64, 80))
    pts, lab, bx = _prompt(points, boxes)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)  # noqa: E731
    jm = JM.PromptEncoder(**kw)
    variables = fill_flax(jm, points=j(pts), labels=j(lab), boxes=j(bx), seed=5)
    sparse, dense = jm.apply(variables, points=j(pts), labels=j(lab), boxes=j(bx))
    pe = jm.apply(variables, method=JM.PromptEncoder.get_dense_pe)
    pm = carry(PM.PromptEncoder(**kw), variables)
    with torch.no_grad():
        gs, gd = pm(points=t(pts), labels=t(lab), boxes=t(bx))
        gpe = pm.get_dense_pe()
    n = (3 + (not boxes) if points else 0) + (4 if boxes else 0)
    assert gs.shape == (2, n, D)
    _close(_np(gs), np.asarray(sparse), "sparse")
    _close(_np(gd), np.asarray(dense).transpose(0, 3, 1, 2), "dense")
    _close(_np(gpe)[0], np.asarray(pe).transpose(2, 0, 1), "dense pe")


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_jax(multimask):
    """The two-way transformer and the mask decoder at transformer width 32
    (8 heads, MLP 2048, cross attentions at half width), both output
    slices."""
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((2, 4, 5, D)).astype(np.float32)
    pe = rng.standard_normal((1, 4, 5, D)).astype(np.float32)
    sparse = rng.standard_normal((2, 3, D)).astype(np.float32)
    dense = rng.standard_normal((2, 4, 5, D)).astype(np.float32)
    jm = JM.MaskDecoder(transformer_dim=D)
    args = [jnp.asarray(a) for a in (emb, pe, sparse, dense)]
    variables = fill_flax(jm, *args, seed=7)
    masks, iou = jm.apply(variables, *args, multimask_output=multimask)
    pm = carry(PM.MaskDecoder(D), variables)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    with torch.no_grad():
        gm, gi = pm(nchw(emb), nchw(pe), torch.from_numpy(sparse), nchw(dense), multimask)
    assert gm.shape == (2, 3 if multimask else 1, 16, 20)
    _close(_np(gm), np.asarray(masks), "masks")
    _close(_np(gi), np.asarray(iou), "iou")


# ---- the facade ------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX SAM, port SAM) of the tiny arch at 64 px with one set of
    variables; the arch is added to both packages' `SAM_ARCHS` for the
    module's tests only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_model.SAM_ARCHS, "sam_t", TINY)
        mp.setitem(port_model.SAM_ARCHS, "sam_t", TINY)
        js = jax_model.SAM("sam_t", img_size=64)
        js.variables = fill_flax(js.module, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 2)),
                                 jnp.ones((1, 1), jnp.int32), seed=8, logit_gain=60.0)
        ps = SAM("sam_t", img_size=64, device="cpu")
        carry(ps.module, js.variables)
        yield js, ps


def _bgr(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(60, 200, (h, w, 3), dtype=np.uint8)
    for _ in range(3):
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y:y + h // 3, x:x + w // 3] = rng.integers(0, 256, 3)
    return img


# (h, w): non-square; long side 2x img_size (the image's uint8 down-ratio
# of 2, cv2's INTER_AREA path); long side half img_size (the masks' float32
# down-ratio of 2)
SHAPES = [(50, 90), (128, 96), (32, 20)]


@pytest.mark.parametrize("shape", SHAPES, ids=["non_square", "down2_image", "down2_masks"])
def test_predict_matches_jax(tiny_pair, shape):
    js, ps = tiny_pair
    img = _bgr(*shape, seed=9)
    xj, sj, hwj = js._prep(img)
    xp, sp, hwp = ps._prep(img)
    assert (sj, hwj) == (sp, hwp)
    np.testing.assert_array_equal(_np(xp)[0].transpose(1, 2, 0), np.asarray(xj)[0])
    pts = np.array([[[shape[1] * 0.3, shape[0] * 0.6], [shape[1] * 0.7, shape[0] * 0.2]]],
                   np.float32)
    for points, labels in ((None, None), (pts, np.array([[1, 0]], np.int32))):
        wm, wi = js.predict(img, points=points, labels=labels)
        gm, gi = ps.predict(img, points=points, labels=labels)
        assert gm.shape == wm.shape == (1, 3, *shape)
        _close(gm, wm, "mask logits")
        _close(gi, wi, "predicted iou")
        tie = np.abs(wm) <= ATOL
        assert ((gm > 0) == (wm > 0))[~tie].all()
        assert np.abs(wm).max() > 1.0  # logits of a few units: the test has teeth
    # the float32 resizes alone, on one set of low-res logits
    low = np.random.default_rng(10).standard_normal((1, 2, 16, 16)).astype(np.float32) * 5
    want = js._postprocess_masks(low, sj, hwj)
    got = ps._postprocess_masks(torch.from_numpy(low), sp, hwp)
    np.testing.assert_array_equal(_np(got), want)  # cv2's float32 bits


def _gap_threshold(values, lo, hi):
    """A threshold in the widest gap of `values` inside (lo, hi)."""
    v = np.unique(np.asarray(values, np.float64))
    v = v[(v > lo) & (v < hi)]
    i = int(np.argmax(np.diff(v)))
    return float((v[i] + v[i + 1]) / 2), float(np.diff(v)[i] / 2)


@pytest.mark.parametrize("shape", [(50, 90), (32, 20)], ids=["non_square", "down2_masks"])
def test_generate_matches_jax(tiny_pair, shape):
    """The point grid's masks through JAX's filters, 16-pixel floor and
    mask-IoU de-duplication: the same kept masks in the same order."""
    js, ps = tiny_pair
    img = _bgr(*shape, seed=11)
    # JAX's predicted IoUs and stability scores of the grid, to set the
    # thresholds in gaps of them
    x, scale, (h0, w0) = js._prep(img)
    grid = jax_amg.build_point_grid(8)
    pts = (grid * np.array([w0, h0], np.float32))[:, None, :]
    low, ious = jax.device_get(js._decode(
        js.variables, jnp.broadcast_to(js._encode(js.variables, x), (64, 4, 4, 256)),
        jnp.asarray(pts * scale, jnp.float32), jnp.ones((64, 1), jnp.int32)))
    stab = jax_amg.calculate_stability_score(low.reshape(-1, 16, 16), 0.0, 1.0)
    t_iou, g_iou = _gap_threshold(ious, np.quantile(ious, 0.3), np.quantile(ious, 0.7))
    t_st, g_st = _gap_threshold(stab, np.quantile(stab, 0.05), np.quantile(stab, 0.5))
    assert min(g_iou, g_st) > ATOL  # no value within 1e-4 of a threshold
    kw = dict(points_per_side=8, pred_iou_thresh=t_iou, stability_score_thresh=t_st)
    want = js.generate(img, **kw)
    got = ps.generate(img, **kw)
    n_pass = int(((ious.reshape(-1) > t_iou) & (stab >= t_st)).sum())
    assert 0 < len(want) < n_pass  # the de-duplication (or the floor) dropped some
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["area"], g["bbox"]) == (w["area"], w["bbox"])
        np.testing.assert_array_equal(g["segmentation"], w["segmentation"])
        assert g["stability_score"] == w["stability_score"]
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= ATOL


def test_facade_refusals_and_defaults(tmp_path):
    with pytest.raises(FileNotFoundError):
        SAM(str(tmp_path / "sam_b.pt"), device="cpu")
    with pytest.raises(ValueError, match="unknown SAM variant"):
        SAM("sam_x", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SAM("sam_b", img_size=64)


# ---- amg.py ----------------------------------------------------------------
def test_point_grids_and_crop_boxes_match_jax():
    for n in (1, 8, 32):
        np.testing.assert_array_equal(amg.build_point_grid(n), jax_amg.build_point_grid(n))
    for a, b in zip(amg.build_all_layer_point_grids(32, 2, 2),
                    jax_amg.build_all_layer_point_grids(32, 2, 2)):
        np.testing.assert_array_equal(a, b)
    for size, layers in (((480, 640), 2), ((1080, 1920), 1), ((333, 211), 3)):
        assert amg.generate_crop_boxes(size, layers, 512 / 1500) == \
            jax_amg.generate_crop_boxes(size, layers, 512 / 1500)


def test_stability_rle_and_boxes_match_jax():
    rng = np.random.default_rng(12)
    logits = rng.normal(0, 2, (5, 32, 40)).astype(np.float32)
    np.testing.assert_array_equal(amg.calculate_stability_score(logits, 0.0, 1.0),
                                  jax_amg.calculate_stability_score(logits, 0.0, 1.0))
    masks = logits > 0.5
    masks[1] = False
    masks[2, 0, 0] = True
    for m in masks:
        rle = amg.mask_to_rle(m)
        assert rle == jax_amg.mask_to_rle(m)
        np.testing.assert_array_equal(amg.rle_to_mask(rle), jax_amg.rle_to_mask(rle))
        np.testing.assert_array_equal(amg.rle_to_mask(rle), m)
        assert amg.area_from_rle(rle) == jax_amg.area_from_rle(rle) == int(m.sum())
    np.testing.assert_array_equal(amg.batched_mask_to_box(masks.reshape(5, 1, 32, 40)),
                                  jax_amg.batched_mask_to_box(masks.reshape(5, 1, 32, 40)))
    boxes = rng.uniform(0, 640, (20, 4)).astype(np.float32)
    for crop in ([0, 0, 320, 240], [100, 50, 640, 480]):
        np.testing.assert_array_equal(
            amg.is_box_near_crop_edge(boxes, crop, [0, 0, 640, 480]),
            jax_amg.is_box_near_crop_edge(boxes, crop, [0, 0, 640, 480]))


def test_region_labels_are_cv2s():
    """scipy's regions renumbered as cv2 5's `connectedComponentsWithStats`
    numbers them (by 2x2 block, not by first pixel: the two orders differ
    on these masks)."""
    import cv2
    from scipy import ndimage
    rng = np.random.default_rng(13)
    differ = 0
    for h, w in ((12, 12), (31, 17), (64, 80), (1, 9)):
        for p in (0.1, 0.3, 0.6):
            m = (rng.random((h, w)) < p).astype(np.uint8)
            n, want, _, _ = cv2.connectedComponentsWithStats(m, 8)
            got, k = amg.label_regions(m)
            assert k + 1 == n
            np.testing.assert_array_equal(got, want)
            differ += not np.array_equal(ndimage.label(m, np.ones((3, 3)))[0], want)
    assert differ


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(mode):
    rng = np.random.default_rng(14)
    for p, thresh in ((0.3, 4), (0.55, 6), (0.5, 1)):
        mask = rng.random((40, 48)) < p
        got, changed = amg.remove_small_regions(mask, thresh, mode)
        want, w_changed = jax_amg.remove_small_regions(mask, thresh, mode)
        assert changed == w_changed
        np.testing.assert_array_equal(got, want)


def test_remove_small_islands_keeps_the_largest_when_all_are_small():
    mask = np.zeros((20, 20), bool)
    mask[1:3, 1:3] = True      # 4 px
    mask[10:12, 5:8] = True    # 6 px, the largest
    mask[15, 15] = True
    got, changed = amg.remove_small_regions(mask, 50, "islands")
    want, w_changed = jax_amg.remove_small_regions(mask, 50, "islands")
    assert changed and w_changed
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 6 and got[10:12, 5:8].all()


# ---- the key map and `.pt` files -------------------------------------------
@pytest.fixture(scope="module")
def sam_b_state():
    """A full `sam_b` state dict under the reference's names (the published
    widths; position tables for 64 px), from the port's seeded `sam_b`
    through the inverse of `translate_sam_key`, with the reference's
    mask-prompt tower, which both packages skip."""
    own = port_model.init_sam(Sam("sam_b", img_size=64), seed=3).state_dict()
    inverse = {translate_sam_key(k): k for k in own}
    assert all(inverse[k] == k for k in own)  # the port keeps the reference's names
    state = {inverse[k]: v.numpy() for k, v in own.items()}
    state["prompt_encoder.mask_downscaling.0.weight"] = np.zeros((4, 1, 2, 2), np.float32)
    state["prompt_encoder.mask_downscaling.1.weight"] = np.ones(4, np.float32)
    return state


def test_sam_b_key_map_lands_in_both_packages(sam_b_state):
    ps = Sam("sam_b", img_size=64)
    report = load_sam_state_dict(ps, sam_b_state, verbose=False)
    assert report["name_missed"] == [] and report["shape_missed"] == []
    assert report["matched"] == len(sam_b_state) - 2 == len(ps.state_dict())
    jm = jax_model.Sam(arch="sam_b", img_size=64)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 2)),
                                              jnp.ones((1, 1), jnp.int32)),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    jvars, jrep = jax_load_sam_state_dict(zeros, sam_b_state, verbose=False)
    assert jrep["name_missed"] == [] and jrep["shape_missed"] == []
    assert jrep["matched"] == report["matched"]
    assert sum(x.size for x in jax.tree.leaves(jvars)) == sum(
        v.numel() for v in ps.state_dict().values())
    # one set of values in both: the same decode on an embedding
    rng = np.random.default_rng(15)
    emb = rng.standard_normal((1, 4, 4, 256)).astype(np.float32)
    pts = rng.uniform(0, 64, (1, 2, 2)).astype(np.float32)
    lab = np.array([[1, 0]], np.int32)
    wm, wi = jm.apply(jvars, jnp.asarray(emb), jnp.asarray(pts), jnp.asarray(lab),
                      method=jax_model.Sam.decode)
    with torch.no_grad():
        gm, gi = ps.eval().decode(torch.from_numpy(emb.transpose(0, 3, 1, 2).copy()),
                                  torch.from_numpy(pts), torch.from_numpy(lab).long())
    _close(_np(gm), np.asarray(wm), "sam_b masks")
    _close(_np(gi), np.asarray(wi), "sam_b iou")
    # JAX's loaded tree carried back onto the port is the state given, bit for
    # bit: `state_from_flax` inverts JAX's relayouts
    back = state_from_flax(ps, jvars)
    for k, v in ps.state_dict().items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_flax_relayouts_invert_the_import_ones():
    """Each kind of key's flax path and relayout: the port's `_linear_w`,
    `_conv_w`, `_convT_w` (`utils/torch_import.py`, JAX's own) undone."""
    rng = np.random.default_rng(16)
    cases = {"image_encoder.blocks.3.attn.qkv.weight": ((12, 4), _linear_w, "linear"),
             "image_encoder.neck.2.weight": ((6, 5, 3, 3), _conv_w, "conv"),
             "mask_decoder.output_upscaling.3.weight": ((8, 4, 2, 2), _convT_w, "convT"),
             "prompt_encoder.point_embeddings.2.weight": ((1, 8), None, "direct")}
    paths = {"image_encoder.blocks.3.attn.qkv.weight": ("image_encoder", "blocks_3", "attn",
                                                        "qkv", "kernel"),
             "image_encoder.neck.2.weight": ("image_encoder", "neck_conv2", "kernel"),
             "mask_decoder.output_upscaling.3.weight": ("mask_decoder", "upscale_conv2", "kernel"),
             "prompt_encoder.point_embeddings.2.weight": ("prompt_encoder", "point_embed_2")}
    for key, (shape, fwd, kind) in cases.items():
        assert flax_path(key) == (paths[key], kind)
        a = rng.standard_normal(shape).astype(np.float32)
        tree = node = {}
        for p in paths[key][:-1]:
            node = node.setdefault(p, {})
        node[paths[key][-1]] = fwd(a) if fwd else a

        class One(torch.nn.Module):
            def state_dict(self):
                return {key: torch.from_numpy(a)}
        np.testing.assert_array_equal(state_from_flax(One(), tree)[key], a)
    assert flax_path("prompt_encoder.mask_downscaling.0.weight") is None


def test_sam_pt_file_loads(sam_b_state, tmp_path):
    path = tmp_path / "sam_b.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sam_b_state.items()}, path)
    s = SAM(str(path), img_size=64, device="cpu")
    for k, v in s.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sam_b_state[k], err_msg=k)
    assert s.load(str(path))["matched"] == len(sam_b_state) - 2
