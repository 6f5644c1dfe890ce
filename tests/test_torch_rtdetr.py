"""RT-DETR in the port against the JAX package on the CPU: the transformer
layers (attention, the AIFI encoder, C3TR's block, the MLP), multi-scale
deformable attention (locations outside the maps included), the decoder
in eval and train (with the denoising group fed JAX's own draws), the
Hungarian matcher, `get_cdn_group`, a narrow RT-DETR config and
`yolov8n-rtdetr` as whole models, the DETR loss with its gradients, two
SGD steps of `RTDETRTrainer`, the validator and the predictor; then the
port's own entry points (the facade, npz, a training epoch with its
validation and checkpoint, `YOLO`'s refusal).

Every comparison starts from JAX's variables (shape-only init, then
`test_torch_model._randomize`: random norm statistics, scales and biases),
carried across by `weights.py`, on non-square inputs (64 x 96: the AIFI
embedding's transposition and the anchors' (h, w) division show only
there). Tolerances, each with its reason:

* float64 on both sides: 1e-7 of the largest magnitude (at least 1). JAX
  rounds its attention logits and softmaxes to float32 even in a float64
  model (`preferred_element_type`), the port rounds them the same way, and
  XLA's float32 exp and log differ from PyTorch's by an ulp: ~6e-8 is
  what remains (observed);
* float32: 1e-4 of it, and the queries compared as sets (each JAX query
  has a port query within the limit on its box and scores, one to one):
  float32 rounding flips the order of near-tied encoder scores (two
  scores 1e-7 apart swap their positions);
* the matcher's indices and the denoising group exactly (its boxes'
  logits to 1e-6: XLA's float32 log and PyTorch's differ by an ulp);
* the loss in float64: total and parts 1e-6 relative; each gradient 1e-5
  of its tensor's largest plus 1e-6 of the largest gradient of all (the
  float32 rounding inside JAX's attention, carried back); after two SGD
  steps each parameter's and EMA's change 1e-5 of its largest plus 1e-6
  of the largest change of all, batch statistics 1e-6;
* the validator's metrics 1e-6, the predictor's boxes 1e-3 px and scores
  1e-5 with the classes exact (float32 on both sides, sets of queries
  above the threshold in the same order).
"""
import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.optimize
import torch

from mgdt_yolo_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from mgdt_yolo_tpu.nn.modules import transformer as JT
from mgdt_yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from mgdt_yolo_tpu.vit.rtdetr.predict import RTDETRPredictor as JaxRTDETRPredictor
from mgdt_yolo_tpu.vit.rtdetr.train import RTDETRTrainer as JaxRTDETRTrainer
from mgdt_yolo_tpu.vit.rtdetr.train import _DETRCriterion as JaxDETRCriterion
from mgdt_yolo_tpu.vit.rtdetr.val import RTDETRValidator as JaxRTDETRValidator
from mgdt_yolo_tpu.vit.utils import loss as jax_loss
from mgdt_yolo_tpu.vit.utils import ops as jax_ops
from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS, UNAUGMENTED
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, to_device
from mgdt_yolo_tpu_torch.data.synthetic import SyntheticDetectionDataset, val_dataset
from mgdt_yolo_tpu_torch.nn.modules import transformer as T
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel, RTDETRDetectionModel, model_class
from mgdt_yolo_tpu_torch.vit import RTDETR
from mgdt_yolo_tpu_torch.vit.rtdetr import RTDETRPredictor, RTDETRTrainer, RTDETRValidator
from mgdt_yolo_tpu_torch.vit.utils.loss import DETRLoss
from mgdt_yolo_tpu_torch.vit.utils.ops import HungarianMatcher, cdn_noise, get_cdn_group
from mgdt_yolo_tpu_torch.weights import flatten_variables, flax_keys, load_jax_variables, load_state
from test_torch_ablation_train import _flax
from test_torch_model import _nest, _randomize
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL32, RTOL64 = 1e-4, 1e-7
H, W = 64, 96
# a narrow RT-DETR: HGNetV2 blocks, AIFI on the stride-32 map, a RepC3 neck
# and the decoder on the stride-16 level (one level keeps JAX's compile of
# the 6-layer, 8-head decoder short; the decoder's own tests take three)
NARROW = {
    "nc": 3,
    "backbone": [
        [-1, 1, "HGStem", [8, 16]],                         # 0  /4
        [-1, 1, "HGBlock", [8, 16, 3]],                     # 1
        [-1, 1, "DWConv", [32, 3, 2, 1, False]],            # 2  /8
        [-1, 2, "HGBlock", [8, 32, 3, True, False]],        # 3
        [-1, 1, "DWConv", [32, 3, 2, 1, False]],            # 4  /16
        [-1, 2, "HGBlock", [16, 32, 5, True, True]],        # 5
        [-1, 1, "DWConv", [64, 3, 2, 1, False]],            # 6  /32
    ],
    "head": [
        [-1, 1, "Conv", [32, 1, 1, None, 1, 1, False]],     # 7
        [-1, 1, "AIFI", [64, 8]],                           # 8
        [-1, 1, "Conv", [32, 1, 1]],                        # 9
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],       # 10
        [5, 1, "Conv", [32, 1, 1, None, 1, 1, False]],      # 11
        [[-2, -1], 1, "Concat", [1]],                       # 12
        [-1, 2, "RepC3", [32]],                             # 13
        [[13], 1, "RTDETRDecoder", ["nc", 32]],             # 14
    ],
}


def _close(got, want, rel, what, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert err <= rel * scale + atol, f"{what}: max |diff| {err:.3e}, scale {scale:.3e}"


def _init(jm, *inputs, seed=0, **kw):
    """JAX's variables of a module by JAX's shape-only init
    (`nn.tasks.fast_init`'s fills: kernels uniform by fan-in, scales and
    variances 1, the rest 0; flax's random initialisers cost seconds to
    compile), then randomised norm statistics, scales and biases."""
    shapes = jax.eval_shape(lambda k: jm.init(k, *inputs, **kw),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        name = path[-1].key
        if name == "kernel":
            fan = int(np.prod(sds.shape[:-1]))
            return rng.uniform(-1, 1, sds.shape).astype(np.float32) / np.sqrt(fan)
        if name in ("scale", "var"):
            return np.ones(sds.shape, np.float32)
        return (rng.standard_normal(sds.shape) * 0.5).astype(np.float32)
    return _randomize(jax.tree_util.tree_map_with_path(fill, shapes), seed)


def _f64(flat):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(flat))


def _same_queries(got_b, got_s, want_b, want_s, rel, what):
    """Each image's queries (box, scores) one to one within `rel` of the
    largest magnitude: JAX's query i against the port's query it is
    matched to (the assignment minimising the largest difference)."""
    for j in range(want_b.shape[0]):
        g = np.concatenate([got_b[j], got_s[j]], -1).astype(np.float64)
        w = np.concatenate([want_b[j], want_s[j]], -1).astype(np.float64)
        d = np.abs(g[:, None] - w[None]).max(-1)
        rows, cols = scipy.optimize.linear_sum_assignment(d)
        err = float(d[rows, cols].max())
        assert err <= rel * max(1.0, float(np.abs(w).max())), f"{what}: image {j} {err:.3e}"


def _nchw(xs, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).to(dtype) for x in xs]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _tokens(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _layers():
    """name -> (JAX module, port module, inputs, kwargs, port call)."""
    mask = np.zeros((7, 9), bool)
    mask[:, 5:] = True
    mask[0, :3] = True  # no row fully blocked
    q, kv = _tokens(2, 7, 16, seed=1), _tokens(2, 9, 16, seed=2)
    x_map = _tokens(2, 6, 10, 16, seed=3)  # NHWC, H != W
    return {
        "MultiHeadAttention_mask": (JT.MultiHeadAttention(16, 4), T.MultiHeadAttention(16, 4),
                                    (q, kv, kv, mask), {}),
        "TransformerEncoderLayer": (JT.TransformerEncoderLayer(16, 32, 4),
                                    T.TransformerEncoderLayer(16, 32, 4),
                                    (kv, _tokens(1, 9, 16, seed=4)), {}),
        "AIFI": (JT.AIFI(16, 32, 4), T.AIFI(16, 32, 4), (x_map,), {}),
        "TransformerLayer": (JT.TransformerLayer(16, 4), T.TransformerLayer(16, 4), (kv,), {}),
        "TransformerBlock": (JT.TransformerBlock(24, 4, 2), T.TransformerBlock(16, 24, 4, 2),
                             (x_map,), {}),
        "MLP": (JT.MLP(32, 5, 3), T.MLP(16, 32, 5, 3), (kv,), {}),
    }


def _port_inputs(name, inputs, dtype):
    if name in ("AIFI", "TransformerBlock"):
        return _nchw(inputs, dtype)
    out = [torch.from_numpy(np.asarray(x)) for x in inputs]
    return [t if t.dtype == torch.bool else t.to(dtype) for t in out]


@pytest.mark.parametrize("name", sorted(_layers()))
def test_transformer_layers_match_jax(name):
    """Each layer on JAX's variables, float32 and float64 (the embedding
    added W-major to H-major tokens on AIFI's 6 x 10 map, as JAX's)."""
    jm, pm, inputs, kw = _layers()[name]
    flat = _init(jm, *[jnp.asarray(x) for x in inputs], **kw)
    assert set(flax_keys(pm).values()) == set(flat)
    load_state(pm, load_jax_variables(flat))
    pm.eval()
    for dtype, jdt, rel in ((torch.float32, jnp.float32, RTOL32), (torch.float64, jnp.float64, RTOL64)):
        with jax.enable_x64(jdt == jnp.float64):
            jmd = jm.clone(dtype=jdt)
            xs = [jnp.asarray(x) if x.dtype == bool else jnp.asarray(x, jdt) for x in inputs]
            want = np.asarray(jax.jit(jmd.apply)(_f64(flat) if jdt == jnp.float64 else _nest(flat),
                                                *xs))
        with torch.no_grad():
            got = pm.to(dtype)(*_port_inputs(name, inputs, dtype))
        if got.dim() == 4:
            got = got.permute(0, 2, 3, 1)
        _close(got.numpy(), want, rel, f"{name} {dtype}")


def test_sincos_embedding_is_jaxs_bits():
    """The embedding on a non-square map is JAX's array bit for bit, and
    transposed against the tokens (row w * H + h goes to token h * W + w)."""
    want = np.asarray(JT.AIFI._sincos_embed(10, 6, 16))
    got = T.sincos_embed(10, 6, 16)
    np.testing.assert_array_equal(got, want)
    # token 1 (h 0, w 1) gets row 1, the embedding of (w 0, h 1): its w
    # quarter (sin of w) is 0 and its h quarter is not
    assert not got[0, 1, :4].any() and got[0, 1, 8:12].all()


@pytest.mark.parametrize("ref", ["boxes", "points"])
def test_msdeform_attn_matches_jax(ref):
    """Three levels of 8 x 12, 4 x 6 and 2 x 3, reference boxes (xywh) or
    points near the maps' edges and sampling offsets scaled up so that a
    large share of the points fall outside the maps (zeros there, as
    grid_sample's padding and JAX's bounds mask), float64 (and float32 on
    the boxes)."""
    shapes = [(8, 12), (4, 6), (2, 3)]
    rng = np.random.default_rng(5)
    lv = sum(h * w for h, w in shapes)
    query, value = _tokens(2, 11, 32, seed=6), _tokens(2, lv, 32, seed=7)
    n = 4 if ref == "boxes" else 2
    rb = rng.uniform(-0.1, 1.1, (2, 11, 1, n)).astype(np.float32)
    if ref == "boxes":
        rb[..., 2:] = rng.uniform(0.2, 1.5, (2, 11, 1, 2))
    jm = JT.MSDeformAttn(32, 3, 4, 4)
    flat = _init(jm, jnp.asarray(query), jnp.asarray(rb), jnp.asarray(value), shapes)
    flat["params.sampling_offsets.bias"] = flat["params.sampling_offsets.bias"] * 40
    pm = T.MSDeformAttn(32, 3, 4, 4)
    load_state(pm, load_jax_variables(flat))
    # the share of points outside the maps
    off = np.asarray(query @ flat["params.sampling_offsets.kernel"]
                     + flat["params.sampling_offsets.bias"]).reshape(2, 11, 4, 3, 4, 2)
    if ref == "boxes":
        loc = rb[:, :, None, :, None, :2] + off / 4 * rb[:, :, None, :, None, 2:] * 0.5
    else:
        norm = np.asarray([[w, h] for h, w in shapes], np.float32)
        loc = rb[:, :, None, :, None, :] + off / norm[None, None, None, :, None, :]
    outside = ((loc < 0) | (loc > 1)).any(-1).mean()
    assert 0.2 < outside < 0.95, outside
    cases = ((torch.float64, jnp.float64, RTOL64), (torch.float32, jnp.float32, RTOL32))
    for dtype, jdt, rel in cases[:2 if ref == "boxes" else 1]:
        with jax.enable_x64(jdt == jnp.float64):
            jmd = jm.clone(dtype=jdt)
            want = np.asarray(jax.jit(jmd.apply, static_argnums=4)(
                _f64(flat) if jdt == jnp.float64 else _nest(flat), jnp.asarray(query, jdt),
                jnp.asarray(rb, jdt), jnp.asarray(value, jdt), tuple(shapes)))
        with torch.no_grad():
            got = pm.to(dtype)(*(torch.from_numpy(a).to(dtype) for a in (query, rb, value)), shapes)
        _close(got.numpy(), want, rel, f"MSDeformAttn {ref} {dtype}")


# ---------------------------------------------------------------------------
# the decoder, the denoising group, the matcher
# ---------------------------------------------------------------------------

DEC = dict(nc=5, ch=(16, 24, 32), hd=32, nq=20, nh=4, ndl=2, d_ffn=64)
DEC_SHAPES = [(8, 12), (4, 6), (2, 3)]


def _decoder_case():
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((2, h, w, c)).astype(np.float32)
          for (h, w), c in zip(DEC_SHAPES, DEC["ch"])]
    jd = JT.RTDETRDecoder(**DEC)
    flat = _init(jd, [jnp.asarray(x) for x in xs], seed=9, train=True)
    pd = T.RTDETRDecoder(**DEC)
    load_state(pd, load_jax_variables(flat))
    return xs, jd, flat, pd


def _gt(b=2, G=4, nc=5, seed=10):
    """Padded targets: normalised xywh boxes, labels, the last of image 1
    padding."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.2, 0.8, (b, G, 2))
    wh = rng.uniform(0.05, 0.4, (b, G, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    cls = rng.integers(0, nc, (b, G)).astype(np.int32)
    mask = np.ones((b, G), bool)
    mask[1, -1] = False
    boxes[1, -1] = 0
    return boxes, cls, mask


def _jax_draws(key, b, D, nc):
    """JAX's `get_cdn_group` draws from `key`, in its order (in the
    enabled precision, as its trainer's step draws them)."""
    def draw(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {"flip": jax.random.uniform(k1, (b, D)),
                "cls": jax.random.randint(k2, (b, D), 0, nc),
                "sign": jax.random.rademacher(k3, (b, D, 4), dtype=jnp.float32),
                "part": jax.random.uniform(jax.random.fold_in(k3, 1), (b, D, 4))}
    return {k: torch.from_numpy(np.array(v)) for k, v in jax.jit(draw)(key).items()}


def test_cdn_group_matches_jax_on_its_draws():
    """`get_cdn_group` fed JAX's draws: labels, boxes (logit space), the
    embeddings, the attention mask (every row sees itself: none is fully
    blocked) and the metadata, exactly; without draws, a generator's have
    the same shapes and the same mask."""
    boxes, cls, mask = _gt()
    embed = np.random.default_rng(11).standard_normal((5, 32)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    def group(cls, boxes, mask, embed, key):
        e, bb, m, meta = jax_ops.get_cdn_group(cls, boxes, mask, 5, 20, embed, key=key)
        return e, bb, m, {k: meta[k] for k in ("dn_valid", "dn_cls", "neg_idx")}
    want = jax.jit(group)(jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask),
                          jnp.asarray(embed), key)
    G, groups = 4, 100 // 4
    D = 2 * G * groups
    got = get_cdn_group(torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask), 5,
                        20, torch.from_numpy(embed), noise=_jax_draws(key, 2, D, 5))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # the labels' embeddings
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the noised boxes' logits: XLA's float32 log and PyTorch's differ by an ulp
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    assert got[2].shape == (20 + D, 20 + D) and not bool(got[2].all(-1).any())
    gm, wm = got[3], want[3]
    assert (gm["dn_num_group"], gm["dn_num_split"], gm["group_size"]) == (groups, [D, 20], 2 * G)
    for k in ("dn_valid", "dn_cls", "neg_idx"):
        np.testing.assert_array_equal(gm[k].numpy(), np.asarray(wm[k]), err_msg=k)
    other = get_cdn_group(torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask),
                          5, 20, torch.from_numpy(embed),
                          generator=torch.Generator().manual_seed(0))
    assert [t.shape for t in other[:3]] == [t.shape for t in got[:3]]
    assert torch.equal(other[2], got[2])
    noise = cdn_noise(2, D, 5, torch.Generator().manual_seed(0))
    assert set(noise["sign"].unique().tolist()) == {-1.0, 1.0}


def test_matcher_indices_match_jax():
    """JAX's and the port's matchers on the same predictions: the same cost
    (float32 class term) and the same indices, in float64 and float32,
    with padded targets unmatched."""
    rng = np.random.default_rng(12)
    b, nq, nc = 2, 30, 5
    boxes, cls, mask = _gt(b, 6, nc)
    pb = np.concatenate([rng.uniform(0.1, 0.9, (b, nq, 2)), rng.uniform(0.05, 0.5, (b, nq, 2))],
                        -1)
    ps = rng.standard_normal((b, nq, nc)) * 2
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        with jax.enable_x64(jdt == jnp.float64):
            want = np.asarray(jax.jit(jax_ops.HungarianMatcher().__call__)(
                jnp.asarray(pb, jdt), jnp.asarray(ps, jdt), jnp.asarray(boxes), jnp.asarray(cls),
                jnp.asarray(mask)))
        got = HungarianMatcher()(torch.from_numpy(pb).to(dt), torch.from_numpy(ps).to(dt),
                                 torch.from_numpy(boxes), torch.from_numpy(cls),
                                 torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got >= 0).sum(1).tolist() == [6, 5]


@pytest.mark.parametrize("kw", [{"use_fl": True}, {"use_fl": False},
                                {"cost_gain": {"class": 1, "bbox": 3, "giou": 4}, "use_fl": True,
                                 "alpha": 0.4, "gamma": 1.5},
                                {"cost_gain": {"class": 3, "bbox": 1, "giou": 1}, "use_fl": False}],
                         ids=["focal", "plain", "focal_gains", "plain_gains"])
def test_matcher_options_match_jax(kw):
    """JAX's matcher arguments (`cost_gain`, `use_fl`, `alpha`, `gamma`)
    give the port JAX's indices on the same float32 predictions; the plain
    `-score` class cost and the focal one pick different matches here."""
    rng = np.random.default_rng(13)
    b, nq, nc = 2, 24, 5
    boxes, cls, mask = _gt(b, 6, nc)
    pb = np.concatenate([rng.uniform(0.1, 0.9, (b, nq, 2)), rng.uniform(0.05, 0.5, (b, nq, 2))],
                        -1).astype(np.float32)
    ps = (rng.standard_normal((b, nq, nc)) * 2).astype(np.float32)
    want = np.asarray(jax_ops.HungarianMatcher(**kw)(
        jnp.asarray(pb), jnp.asarray(ps), jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(mask)))
    got = HungarianMatcher(**kw)(torch.from_numpy(pb), torch.from_numpy(ps),
                                 torch.from_numpy(boxes), torch.from_numpy(cls),
                                 torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    other = HungarianMatcher(**{**kw, "use_fl": not kw["use_fl"]})(
        torch.from_numpy(pb), torch.from_numpy(ps), torch.from_numpy(boxes),
        torch.from_numpy(cls), torch.from_numpy(mask))
    assert not torch.equal(other, got)


@pytest.mark.parametrize("case", ["vfl", "vfl_no_targets", "focal", "ce", "gains"])
def test_detr_loss_options_match_jax(case):
    """Each of JAX's class-loss branches (varifocal; varifocal on a batch
    without targets, which takes the focal loss with gamma 1.5; focal alone
    with `use_vfl=False`; softmax cross-entropy with `use_fl=False`) and a
    non-default `loss_gain`, on two stacked float32 layers: every part
    within 1e-5 of JAX's, relative."""
    kw = {"vfl": {}, "vfl_no_targets": {}, "focal": {"use_vfl": False},
          "ce": {"use_vfl": False, "use_fl": False},
          "gains": {"loss_gain": {"class": 2.5, "bbox": 1.5, "giou": 0.5}}}[case]
    rng = np.random.default_rng(14)
    L, b, nq, nc = 2, 2, 20, 5
    boxes, cls, mask = _gt(b, 6, nc)
    if case == "vfl_no_targets":
        mask[:] = False
    pb = np.concatenate([rng.uniform(0.1, 0.9, (L, b, nq, 2)),
                         rng.uniform(0.05, 0.5, (L, b, nq, 2))], -1).astype(np.float32)
    ps = (rng.standard_normal((L, b, nq, nc)) * 2).astype(np.float32)
    batch = {"gt_bboxes_norm": boxes, "gt_labels": cls, "mask_gt": mask}
    w_total, want = jax_loss.DETRLoss(nc, **kw)(jnp.asarray(pb), jnp.asarray(ps),
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    g_total, got = DETRLoss(nc, **kw)(torch.from_numpy(pb), torch.from_numpy(ps),
                                      {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].item(), float(want[k]), 1e-5, k)
    _close(g_total.item(), float(w_total), 1e-5, "total")
    port_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if case == "vfl_no_targets":  # the focal loss, as `use_vfl=False` computes it
        _, focal = DETRLoss(nc, use_vfl=False)(torch.from_numpy(pb), torch.from_numpy(ps),
                                               port_batch)
        assert got["loss_class"].item() == focal["loss_class"].item()
    elif case != "vfl":  # the branch or the gains change the loss
        _, base = DETRLoss(nc)(torch.from_numpy(pb), torch.from_numpy(ps), port_batch)
        assert abs(base["loss_class"].item() - got["loss_class"].item()) > 1e-3


def test_decoder_eval_matches_jax():
    """The decoder over three non-square levels (126 tokens, many outside
    the anchors' margin: zeroed, tied scores, taken in index order) at nq
    20, float64 exactly, float32 as sets; folded (`fuse`) as unfolded (the
    whole models' tests take every token: nq 300 above their count)."""
    xs, jd, flat, pd = _decoder_case()
    pd.eval()
    for nq in (20,):
        with jax.enable_x64(True):
            jdn = jd.clone(dtype=jnp.float64, nq=nq)
            want = jax.device_get(jax.jit(lambda v, xs: jdn.apply(v, xs)[0][:4])(
                _f64(flat), [jnp.asarray(x, jnp.float64) for x in xs]))
        pd.nq = nq
        with torch.no_grad():
            got = pd.double()(_nchw(xs, torch.float64))
        assert got[0].shape == (1, 2, min(nq, 126), 4) and got[4] is None
        for g, w, what in zip(got[:4], want, ("boxes", "scores", "enc boxes", "enc scores")):
            _close(g.numpy(), w, RTOL64, f"nq {nq} {what}")
        pd.float()
        with torch.no_grad():
            g32 = pd(_nchw(xs))
        _same_queries(g32[0][0].numpy(), g32[1][0].numpy(), want[0][0], want[1][0], RTOL32,
                      f"nq {nq} float32")
    fused = copy.deepcopy(pd)
    assert fused.fuse() and not fused.fuse()
    with torch.no_grad():
        a, b = pd(_nchw(xs)), fused(_nchw(xs))
    _same_queries(b[0][0].numpy(), b[1][0].numpy(), a[0][0].numpy(), a[1][0].numpy(), RTOL32,
                  "fused")


def test_decoder_train_matches_jax():
    """The training forward (batch statistics, every layer, each layer
    after the first refined from the previous layer's undetached boxes)
    with the denoising group of JAX's draws, float64: every layer's boxes
    and logits, the encoder's and the group's metadata."""
    xs, jd, flat, pd = _decoder_case()
    boxes, cls, mask = _gt()
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        jdn = jd.clone(dtype=jnp.float64)
        dn = {"gt_labels": jnp.asarray(cls), "gt_bboxes_norm": jnp.asarray(boxes),
              "mask_gt": jnp.asarray(mask), "key": key}

        def run(v, xs):
            (out, _), _ = jdn.apply(v, xs, train=True, dn=dn, mutable=["batch_stats"])
            return out[:4], out[4]["dn_valid"], out[4]["dn_cls"]
        want, w_valid, w_cls = jax.device_get(jax.jit(run)(
            _f64(flat), [jnp.asarray(x, jnp.float64) for x in xs]))
        D = 2 * 4 * (100 // 4)
        noise = _jax_draws(key, 2, D, 5)
    pd.double().train()
    got = pd(_nchw(xs, torch.float64), dn={"gt_labels": torch.from_numpy(cls),
                                           "gt_bboxes_norm": torch.from_numpy(boxes),
                                           "mask_gt": torch.from_numpy(mask), "noise": noise})
    assert got[0].shape == (2, 2, D + 20, 4)
    for g, w, what in zip(got[:4], want, ("boxes", "logits", "enc boxes", "enc scores")):
        _close(g.detach().numpy(), w, RTOL64, f"train {what}")
    np.testing.assert_array_equal(got[4]["dn_valid"].numpy(), w_valid)
    np.testing.assert_array_equal(got[4]["dn_cls"].numpy(), w_cls)
    assert got[4]["dn_num_split"] == [D, 20]


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

_MODELS = {}


def _model(name):
    """(JAX model, JAX's randomised variables), once per config."""
    if name not in _MODELS:
        cfg = copy.deepcopy(NARROW) if name == "narrow" else name
        jm = JaxDetectionModel(cfg)
        _MODELS[name] = (jm, _randomize(jm.variables, seed=3))
    return _MODELS[name]


def _port(name, flat, dtype=torch.float32):
    pm = RTDETRDetectionModel(copy.deepcopy(NARROW) if name == "narrow" else name, device="cpu")
    load_state(pm, load_jax_variables(flat))
    return pm.to(dtype)


def _norm(a):
    return tuple(_norm(x) for x in a) if isinstance(a, (list, tuple)) else a


@pytest.mark.parametrize("name", ["narrow", "yolov8n-rtdetr.yaml"])
def test_model_matches_jax(name):
    """Specs, stride (32), flax names and parameter count as JAX's; the
    eval forward at 64 x 96 in float64 against JAX's float64, and in
    float32 (as sets of queries) unfused and fused."""
    jm, flat = _model(name)
    pm = _port(name, flat)
    assert pm.stride == jm.stride == (32,) and model_class(
        NARROW if name == "narrow" else name) is RTDETRDetectionModel
    for p, j in zip(pm.specs, jm.specs):
        assert (p.i, p.f, p.name, p.n, p.c2) == (j.i, j.f, j.name, j.n, j.c2), p
        assert _norm(p.args) == _norm(j.args), p
    assert set(flax_keys(pm).values()) == set(flatten_variables(jax.device_get(jm.variables)))
    assert sum(p.numel() for p in pm.parameters()) == jm.num_params()
    x = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3))
    with jax.enable_x64(True):
        m64 = jm.model.clone(dtype=jnp.float64)
        want = jax.device_get(jax.jit(lambda v, x: m64.apply(v, x, train=False)[0][:4])(
            _f64(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = pm.double()(torch.from_numpy(x))
    for g, w, what in zip(got[:4], want, ("boxes", "scores", "enc boxes", "enc scores")):
        _close(g.numpy(), w, RTOL64, f"{name} float64 {what}")
    pm.float()
    for fused in (False, True):
        if fused:
            pm.fuse()
        with torch.no_grad():
            g = pm(torch.from_numpy(x).float())
        _same_queries(g[0][0].numpy(), g[1][0].numpy(), want[0][0], want[1][0], RTOL32,
                      f"{name} float32 fused {fused}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

IMGSZ = 96
OVERRIDES = {"optimizer": "SGD", "lr0": 0.1, "weight_decay": 0.05, "batch": 2, "nbs": 2,
             "epochs": 10, "warmup_epochs": 0.0, "amp": False, "imgsz": IMGSZ, **UNAUGMENTED}
STEPS_PER_EPOCH = 1000
_RUN = {}


def _jax_kwargs_fn():
    """JAX's trainer's denoising kwargs (the key folded with the step)."""
    return JaxRTDETRTrainer.get_model_kwargs_fn(
        SimpleNamespace(args=SimpleNamespace(imgsz=IMGSZ)))


def _train_run():
    """A labelled batch of two 96 px scenes; JAX's float64 loss, main parts
    and gradients there (the draws of step 0); and JAX's float64 state
    after two train steps, composed as JAX's `make_train_step` composes
    one (this loss's gradients with the step's draws, JAX's optimizer, the
    EMA's decay ramp) so that one compile of the loss serves both checks;
    once."""
    if _RUN:
        return _RUN
    jm, start = _model("narrow")
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, nc=3, seed=11)
    batch = collate([ds[i] for i in range(2)], IMGSZ, DataLoader(ds, 2, IMGSZ).max_gt)
    _RUN.update(batch=batch, start=start)
    with jax.enable_x64(True):
        m64 = jm.model.clone(dtype=jnp.float64)
        v = _f64(start)
        jb = {k: jnp.asarray(batch[k]) for k in ("img", "gt_labels", "gt_bboxes", "mask_gt")}
        crit, kw_fn = JaxDETRCriterion(3, IMGSZ), _jax_kwargs_fn()

        def loss_fn(params, stats, batch, step):
            img = batch["img"].astype(jnp.float32) / 255.0
            (out, updates) = m64.apply({"params": params, "batch_stats": stats}, img,
                                       train=True, mutable=["batch_stats"], **kw_fn(batch, step))
            lo = crit(out[0], batch, step)
            return lo.total, (updates["batch_stats"], lo.parts)
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, (_, parts)), grads = grad_fn(v["params"], v["batch_stats"], jb, jnp.int32(0))
        _RUN.update(loss=float(loss), parts=np.asarray(parts),
                    grads=flatten_variables(jax.device_get(grads), "params."))
        a = {**TRAIN_DEFAULTS, **OVERRIDES}
        tx = jax_build_optimizer(
            v["params"], "SGD", a["lr0"], a["lrf"], a["momentum"], a["weight_decay"],
            warmup_steps=100, total_steps=STEPS_PER_EPOCH * a["epochs"],
            steps_per_epoch=STEPS_PER_EPOCH, epochs=a["epochs"], cos_lr=False,
            warmup_momentum=a["warmup_momentum"], nc=3, warmup_bias_lr=a["warmup_bias_lr"],
            accumulate=1)
        @jax.jit
        def apply(grads, opt, params, ema, n):
            updates, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
            d = 0.9999 * (1 - jnp.exp(-n.astype(jnp.float32) / 2000.0))
            ema = jax.tree.map(lambda e, p: e * d + (1.0 - d) * p, ema, params)
            return opt, params, ema, optax.global_norm(grads)
        params, stats, ema = v["params"], v["batch_stats"], v["params"]
        opt = jax.jit(tx.init)(params)
        _RUN["metrics"] = []
        for step in range(2):
            (loss, (stats, _)), grads = grad_fn(params, stats, jb, jnp.int32(step))
            opt, params, ema, norm = apply(grads, opt, params, ema, jnp.int32(step + 1))
            _RUN["metrics"].append({"loss": float(loss), "grad_norm": float(norm)})
        _RUN["state"] = SimpleNamespace(**jax.device_get(
            {"params": params, "batch_stats": stats, "ema_params": ema}))
        G = batch["gt_labels"].shape[1]
        D = 2 * G * max(1, 100 // G)
        _RUN["draws"] = [_jax_draws(jax.random.fold_in(jax.random.PRNGKey(0), s), 2, D, 3)
                         for s in range(2)]
    return _RUN


def _trainer(run, dtype=torch.float64):
    pm = _port("narrow", run["start"], dtype)
    return RTDETRTrainer(pm, overrides=OVERRIDES, steps_per_epoch=STEPS_PER_EPOCH,
                         noise_fn=lambda s: run["draws"][s])


def test_loss_and_gradients_match_jax():
    """The training forward with step 0's denoising draws, the DETR loss
    (encoder + 6 decoder layers matched, 6 denoising layers) and every
    parameter's gradient, in float64 against JAX's float64."""
    run = _train_run()
    tr = _trainer(run)
    pm = tr.model
    assert tr.args["mosaic"] == 0.0
    batch = to_device(run["batch"], "cpu")
    out = tr.criterion(tr.forward_train(batch["img"].float() / 255.0, batch), batch, 0)
    out.total.backward()
    np.testing.assert_allclose(out.total.item(), run["loss"], rtol=1e-6)
    np.testing.assert_allclose(out.parts.numpy(), run["parts"], rtol=1e-6)
    keys = flax_keys(pm)
    floor = 1e-6 * max(np.abs(g).max() for g in run["grads"].values())
    for n, p in pm.named_parameters():
        want = run["grads"][keys[n]]
        got = np.zeros_like(want) if p.grad is None else _flax(keys[n], p.grad)
        _close(got, want, 1e-5, f"gradient of {n}", atol=floor)
    assert float(pm.model_14.denoising_class_embed.grad.abs().max()) > 0


def test_two_sgd_steps_match_jax():
    """Two `RTDETRTrainer.train_step`s (fresh draws each step) against JAX's
    two float64 train steps: losses, gradient norms, then parameters, EMA
    and batch statistics."""
    run = _train_run()
    tr = _trainer(run)
    pm = tr.model
    batch = to_device(run["batch"], "cpu")
    metrics = [tr.train_step(batch) for _ in range(2)]
    for got, want in zip(metrics, run["metrics"]):
        np.testing.assert_allclose(got["loss"].item(), want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"], rtol=1e-5)
    state, start = run["state"], run["start"]
    assert tr.step == 2
    params = flatten_variables(state.params, "params.")
    ema = flatten_variables(state.ema_params, "params.")
    stats = flatten_variables(state.batch_stats, "batch_stats.")
    keys, ours_ema = flax_keys(pm), tr.ema.state()
    floor = 1e-6 * max(np.abs(params[k] - start[k]).max() for k in params)
    for n, t in list(pm.named_parameters()) + list(pm.named_buffers()):
        if n not in keys:
            continue
        k = keys[n]
        got, base = _flax(k, t), start[k].astype(np.float64)
        if k in stats:
            _close(got, stats[k], 1e-6, f"batch statistic {n}")
            continue
        _close(got - base, params[k] - base, 1e-5, f"change of {n}", atol=floor)
        _close(_flax(k, ours_ema[n]) - base, ema[k] - base, 1e-5, f"EMA change of {n}",
               atol=floor + float(np.finfo(np.float32).eps) * np.abs(base).max())


# ---------------------------------------------------------------------------
# serving and validation
# ---------------------------------------------------------------------------

def test_validator_matches_jax():
    """JAX's `RTDETRValidator` and the port's on the same weights and the
    synthetic validation scenes at 64 px (float32, conf 0.001, no NMS)."""
    jm, flat = _model("narrow")
    jm.variables = _nest(flat)
    ds = val_dataset(64, 3, 0)
    want = JaxRTDETRValidator({"imgsz": 64, "batch": 4, "conf": 0.001})(jm, dataset=ds,
                                                                        max_batches=2)
    pm = _port("narrow", flat)
    got = RTDETRValidator({"imgsz": 64, "batch": 4, "conf": 0.001})(pm, dataset=ds,
                                                                    max_batches=2)
    for k in ("precision", "recall", "map50", "map", "fitness"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)


def _scenes():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in ((70, 110), (96, 64))]


def test_predictor_matches_jax():
    """JAX's `RTDETRPredictor` and the port's over BGR images of two
    shapes, stretched to 64 px: the same queries above conf (0.3) in
    the same order, boxes in each image's own pixels."""
    jm, flat = _model("narrow")
    jm.variables = _nest(flat)
    jp = JaxRTDETRPredictor(SimpleNamespace(imgsz=64, conf=0.3))
    jp.setup_model(jm)
    w_res = jp(_scenes(), batch=2)
    pm = _port("narrow", flat)
    g_res = RTDETRPredictor(overrides={"imgsz": 64, "conf": 0.3, "device": "cpu"}).setup_model(
        pm)(_scenes(), batch=2)
    assert len(g_res) == len(w_res) == 2
    for g, w in zip(g_res, w_res):
        gd, wd = g.boxes.data, np.asarray(w.boxes.data)
        assert gd.shape == wd.shape and len(gd) > 0
        np.testing.assert_array_equal(gd[:, 5], wd[:, 5])
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], atol=1e-3)
        np.testing.assert_allclose(gd[:, 4], wd[:, 4], atol=1e-5)
        assert g.orig_shape == w.orig_shape


def test_facade_checkpoint_and_yolo_refusal(tmp_path):
    """`RTDETR` serves as its predictor does (a folded copy, `batch=`);
    `RTDETRTrainer` steps an epoch, validates with the RT-DETR validator on
    the EMA weights and writes a checkpoint that `RTDETR(npz)` reloads as
    the same model; `YOLO` refuses an RT-DETR config and
    checkpoint (it would serve it through NMS)."""
    from mgdt_yolo_tpu_torch import YOLO
    y = RTDETR("yolov8n-rtdetr.yaml", device="cpu")
    assert isinstance(y.model, RTDETRDetectionModel) and y.info()[0] == 23
    res = y.predict(_scenes(), imgsz=64, conf=0.0, batch=2)
    want = RTDETRPredictor(overrides={"imgsz": 64, "conf": 0.0, "device": "cpu"}).setup_model(
        copy.deepcopy(y.model))(_scenes(), batch=2)
    for g, w in zip(res, want):
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
    pm = RTDETRDetectionModel("yolov8n-rtdetr.yaml", device="cpu", nc=2)
    over = {**OVERRIDES, "epochs": 1, "imgsz": 64, "lr0": 0.01}
    val = DataLoader(SyntheticDetectionDataset(n=2, imgsz=64, nc=2, seed=2), 2, 64, train=False)
    tr = RTDETRTrainer(pm, DataLoader(SyntheticDetectionDataset(n=4, imgsz=64, nc=2, seed=1), 2,
                                      64), overrides=over, save_dir=tmp_path / "run",
                       val_loader=val)
    # the loop's pieces (`train()` adds the loggers, whose TensorBoard import
    # alone costs seconds here): the steps, the EMA validation, the checkpoint
    losses = [float(tr.train_step(to_device(b, "cpu"))["loss"]) for b in tr.loader]
    metrics = tr.validate()
    assert isinstance(tr.validator, RTDETRValidator) and set(metrics) >= {"map", "fitness"}
    assert len(losses) == 2 and np.isfinite(losses).all()
    npz = tr.save_checkpoint("last")
    back = RTDETR(str(npz), device="cpu").model
    assert back.nc == 2 and isinstance(back, RTDETRDetectionModel)
    ema = tr.ema.state()
    for n, p in back.named_parameters():
        torch.testing.assert_close(p, ema[n], rtol=0, atol=0)
    with pytest.raises(ValueError, match="RT-DETR"):
        YOLO("rtdetr-l.yaml", device="cpu")
    with pytest.raises(ValueError, match="RT-DETR"):
        YOLO(str(npz), device="cpu")
    with pytest.raises(ValueError, match="RT-DETR"):
        DetectionModel("yolov8n-rtdetr.yaml", device="cpu")


def test_full_width_configs_build():
    """rtdetr-l and rtdetr-x build at their published widths (hd 256, nq
    300, 6 decoder layers; AIFI's feed-forward 1024 / 2048) with JAX's
    parameter counts' structure: three levels at 256 / 384 channels."""
    for name, c in (("rtdetr-l.yaml", 256), ("rtdetr-x.yaml", 384)):
        m = RTDETRDetectionModel(name, device="cpu")
        dec = getattr(m, f"model_{m.specs[-1].i}")
        assert (dec.hd, dec.nq, dec.ndl, dec.ch) == (256, 300, 6, (c, c, c))
        aifi = next(mod for mod in m.modules() if isinstance(mod, T.AIFI))
        assert aifi.enc.fc1.out_features == (1024 if c == 256 else 2048)
