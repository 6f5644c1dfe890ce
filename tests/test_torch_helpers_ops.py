"""The JAX package's small public ops and modules in the port, against JAX
on the CPU: `box_iou`, `xywhn2xyxy` and `bbox_iou`'s DIoU; the per-image
NMS `nms_single` (the greedy scan) and `nms_single_fixpoint` (with and
without `block`) on seeded boxes whose scores tie; the dormant assigner
`heuristic_assign_v2`; `ChannelAttention`, `SpatialAttention` and `CBAM`;
the constructor arguments no YAML passes (`g`, `e`, `k` of the CSP blocks,
`Conv_GN`'s `s` and `act`, `DyDCNv2`'s `stride` and `with_norm`); and the
DCN's routing by shape.

Tolerances: boxes, IoUs and NMS rows 1e-6 (the same float32 operations;
NMS selects and copies rows); the assigner's labels, boxes, gt indices and
masks bit for bit and its target scores 1e-6; modules on JAX's variables
(`fast_init`, then norm statistics, scales and biases randomised) 1e-5 of
the largest magnitude (at least 1), as float32 sums in another order allow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgdt_yolo_tpu.nn.modules import block as JB
from mgdt_yolo_tpu.nn.modules import conv as JC
from mgdt_yolo_tpu.nn.modules import head as JH
from mgdt_yolo_tpu.nn.tasks import fast_init
from mgdt_yolo_tpu.ops import boxes as jboxes
from mgdt_yolo_tpu.ops import deform as jdeform
from mgdt_yolo_tpu.ops import nms as jnms
from mgdt_yolo_tpu.utils import tal as jtal
from mgdt_yolo_tpu_torch.nn.modules import block as B
from mgdt_yolo_tpu_torch.nn.modules import conv as C
from mgdt_yolo_tpu_torch.nn.modules import head as H
from mgdt_yolo_tpu_torch.ops import boxes, cuda_deform, deform, nms
from mgdt_yolo_tpu_torch.utils import tal
from mgdt_yolo_tpu_torch.weights import flax_keys, load_jax_variables, load_state
from test_torch_model import _nest, _randomize
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-6
RTOL_MODULE = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def _xyxy(rng, n):
    xy = rng.uniform(0, 60, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 30, (n, 2))], 1).astype(np.float32)


def test_box_iou_and_xywhn2xyxy_match_jax():
    rng = np.random.default_rng(0)
    a, b = _xyxy(rng, 7), _xyxy(rng, 5)
    _close(boxes.box_iou(_t(a), _t(b)), jboxes.box_iou(a, b), ATOL)
    xywhn = rng.uniform(0, 1, (3, 6, 4)).astype(np.float32)
    _close(boxes.xywhn2xyxy(_t(xywhn), 640, 480, 3.0, 5.0),
           jboxes.xywhn2xyxy(xywhn, 640, 480, 3.0, 5.0), 1e-4)


@pytest.mark.parametrize("kw", [{"DIoU": True}, {"DIoU": True, "xywh": False},
                                {"CIoU": True, "GIoU": True}, {"GIoU": True}])
def test_bbox_iou_branches_match_jax(kw):
    """DIoU in both layouts, and CIoU winning over GIoU as in JAX."""
    rng = np.random.default_rng(1)
    a, b = _xyxy(rng, 9), _xyxy(rng, 9)
    if kw.get("xywh", True):
        a, b = (np.concatenate([(x[:, :2] + x[:, 2:]) / 2, x[:, 2:] - x[:, :2]], 1) for x in (a, b))
    _close(boxes.bbox_iou(_t(a), _t(b), **kw), jboxes.bbox_iou(a, b, **kw), ATOL)


# ---------------------------------------------------------------------------
# the per-image NMS
# ---------------------------------------------------------------------------

def _nms_inputs(seed, A=96, nc=3):
    """Clustered boxes, scores on a coarse grid so that many tie."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 100, (6, 2))
    c = centres[rng.integers(0, 6, A)] + rng.normal(0, 4, (A, 2))
    wh = rng.uniform(10, 30, (A, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = (rng.integers(0, 8, (A, nc)) / 8).astype(np.float32)
    return b, scores


NMS_CASES = {"plain": {}, "multi_label": {"multi_label": True},
             "agnostic": {"agnostic": True}, "low_conf": {"conf_thres": 0.1, "iou_thres": 0.3}}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_single_matches_jax(case):
    b, s = _nms_inputs(3)
    kw = {"max_det": 40, **NMS_CASES[case]}
    want, wn = jnms.nms_single(jnp.asarray(b), jnp.asarray(s), **kw)
    got, gn = nms.nms_single(_t(b), _t(s), **kw)
    assert int(gn) == int(wn) > 0 and gn.dtype == torch.int32
    _close(got, want, ATOL)


@pytest.mark.parametrize("block", [0, 16])
@pytest.mark.parametrize("case", ["plain", "multi_label"])
def test_nms_single_fixpoint_matches_jax(case, block):
    b, s = _nms_inputs(4)
    kw = {"max_det": 40, "pre_topk": 64, "block": block, **NMS_CASES[case]}
    want, wn, wk = jnms.nms_single_fixpoint(jnp.asarray(b), jnp.asarray(s), **kw)
    got, gn, gk = nms.nms_single_fixpoint(_t(b), _t(s), **kw)
    assert int(gn) == int(wn) > 0
    _close(got, want, ATOL)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    # the greedy scan keeps the same rows (the fixpoint is the greedy result)
    greedy, n = nms.nms_single(_t(b), _t(s), **{k: v for k, v in kw.items() if k != "block"})
    assert int(n) == int(gn)
    _close(greedy, got, 0)


# ---------------------------------------------------------------------------
# the dormant assigner
# ---------------------------------------------------------------------------

def _assign_inputs(seed, b=3, grid=8, G=4, nc=3):
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(grid) + 0.5, np.arange(grid) + 0.5, indexing="ij")
    anc = (np.stack([xs.ravel(), ys.ravel()], 1) * 8).astype(np.float32)
    A = anc.shape[0]
    pd_scores = rng.uniform(0, 1, (b, A, nc)).astype(np.float32)
    ctr = anc[None] + rng.normal(0, 3, (b, A, 2))
    wh = rng.uniform(6, 30, (b, A, 2))
    pd_bboxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    gxy = rng.uniform(4, grid * 8 - 20, (b, G, 2))
    gt_bboxes = np.concatenate([gxy, gxy + rng.uniform(10, 30, (b, G, 2))], -1)
    gt_labels = rng.integers(0, nc, (b, G))
    mask_gt = np.ones((b, G), bool)
    mask_gt[0, 2:] = False          # padding rows
    mask_gt[2] = False              # an image without targets
    gt_bboxes[~mask_gt] = 0
    gt_labels[~mask_gt] = 0
    return pd_scores, pd_bboxes, anc, gt_labels, gt_bboxes.astype(np.float32), mask_gt, nc


@pytest.mark.parametrize("seed,topk", [(0, 13), (1, 5)])
def test_heuristic_assign_v2_matches_jax(seed, topk):
    ps, pb, anc, gl, gb, mg, nc = _assign_inputs(seed)
    want = jtal.heuristic_assign_v2(*map(jnp.asarray, (ps, pb, anc, gl, gb, mg)),
                                    num_classes=nc, topk=topk)
    got = tal.heuristic_assign_v2(*map(_t, (ps, pb, anc, gl, gb, mg)), num_classes=nc,
                                  topk=topk)
    for name in ("target_labels", "target_gt_idx", "fg_mask", "target_bboxes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    _close(got.target_scores, want.target_scores, ATOL)
    # the dynamic threshold puts 1 / 0.4 at each gt's best anchor
    assert float(got.target_scores.max()) > 1.0
    assert not bool(got.fg_mask[2].any())


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _module_case(jm, pm, x_nhwc, *extra):
    """JAX's module on its randomised shape-only init, the port's on the
    same variables: (port output NHWC, JAX output)."""
    args = [jnp.asarray(x_nhwc), *map(jnp.asarray, extra)]
    flat = _randomize(_init_extra(jm, args) if extra else fast_init(jm, 0, args[0]), seed=2)
    want = np.asarray(jax.jit(jm.apply)(_nest(flat), *args))
    assert set(flax_keys(pm).values()) == set(flat)
    load_state(pm, load_jax_variables(flat))
    pm.eval()
    with torch.no_grad():
        got = pm(*(_t(a).permute(0, 3, 1, 2) for a in (x_nhwc, *extra)))
    return got.permute(0, 2, 3, 1).numpy(), want


def _init_extra(jm, args):
    """A module of several inputs: flax's own init (fast_init takes one)."""
    return jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), *a))(args)


def _hold(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= RTOL_MODULE * scale, (what, err, scale)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["ChannelAttention", "SpatialAttention", "CBAM"])
def test_attention_modules_match_jax(name):
    jm, pm = {"ChannelAttention": (JC.ChannelAttention(), C.ChannelAttention(8)),
              "SpatialAttention": (JC.SpatialAttention(5), C.SpatialAttention(5)),
              "CBAM": (JC.CBAM(7), C.CBAM(8, 7))}[name]
    got, want = _module_case(jm, pm, _x((2, 9, 11, 8)))
    _hold(got, want, name)


# every constructor argument JAX's modules take and no YAML passes, at a
# non-default value: (JAX module, port module, input channels)
CTOR = {
    "C2_g": (lambda: JB.C2(16, n=2, g=2), lambda: B.C2(8, 16, n=2, g=2), 8),
    "C2f_g_e": (lambda: JB.C2f(16, n=2, shortcut=True, g=2, e=0.25),
                lambda: B.C2f(8, 16, n=2, shortcut=True, g=2, e=0.25), 8),
    "C3_g_k": (lambda: JB.C3(16, n=1, g=2, k=((3, 3), (1, 1))),
               lambda: B.C3(8, 16, n=1, g=2, k=((3, 3), (1, 1))), 8),
    "C3x_g": (lambda: JB.C3x(16, n=1, g=2), lambda: B.C3x(8, 16, n=1, g=2), 8),
    "MSPA_C2f_g_e": (lambda: JB.MSPA_C2f(16, 16, n=2, shortcut=True, g=2, e=0.25),
                     lambda: B.MSPA_C2f(16, 16, n=2, shortcut=True, g=2, e=0.25), 16),
    "C3TR_g": (lambda: JB.C3TR(16, n=1, g=2), lambda: B.C3TR(8, 16, n=1, g=2), 8),
    "C3Ghost_g": (lambda: JB.C3Ghost(16, n=1, g=2), lambda: B.C3Ghost(8, 16, n=1, g=2), 8),
    "BottleneckCSP_g": (lambda: JB.BottleneckCSP(16, n=2, g=2),
                        lambda: B.BottleneckCSP(8, 16, n=2, g=2), 8),
    "Conv_GN_s_act": (lambda: JH.Conv_GN(16, 3, 2, act=False),
                      lambda: H.Conv_GN(8, 16, 3, 2, act=False), 8),
    "Conv_GN_relu": (lambda: JH.Conv_GN(16, 3, act=jax.nn.relu),
                     lambda: H.Conv_GN(8, 16, 3, act="relu"), 8),
}


@pytest.mark.parametrize("name", sorted(CTOR))
def test_constructor_arguments_match_jax(name):
    jf, pf, c1 = CTOR[name]
    got, want = _module_case(jf(), pf(), _x((2, 10, 14, c1)))
    _hold(got, want, name)


def _dcn_inputs(B_=2, H_=9, W_=11, C_=16, stride=2, seed=3):
    rng = np.random.default_rng(seed)
    Ho, Wo = (H_ + 2 - 3) // stride + 1, (W_ + 2 - 3) // stride + 1
    x = rng.standard_normal((B_, H_, W_, C_)).astype(np.float32)
    off = rng.uniform(-2.5, 2.5, (B_, Ho, Wo, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (B_, Ho, Wo, 9)).astype(np.float32)
    return x, off, mask


@pytest.mark.parametrize("with_norm", [False, True])
def test_dydcnv2_stride2_matches_jax_exact_path(with_norm):
    """JAX's `auto` dispatch sends stride 2 to its exact XLA gather, the
    port to its plain exact DCN, whatever the model's pin."""
    x, off, mask = _dcn_inputs()
    jm = JB.DyDCNv2(16, stride=2, with_norm=with_norm)
    pm = B.DyDCNv2(16, 16, stride=2, with_norm=with_norm, semantics="windowed")
    got, want = _module_case(jm, pm, x, off, mask)
    _hold(got, want, f"DyDCNv2 stride 2 with_norm={with_norm}")


def test_dydcnv2_stride1_bias_matches_jax():
    """At stride 1 without its norm, the bias goes into the DCN (K1's on the
    card): JAX's module in eval takes its windowed path on the CPU, the
    port's is pinned windowed."""
    x, off, mask = _dcn_inputs(stride=1)
    jm = JB.DyDCNv2(16, stride=1, with_norm=False)
    pm = B.DyDCNv2(16, 16, stride=1, with_norm=False, semantics="windowed")
    got, want = _module_case(jm, pm, x, off, mask)
    _hold(got, want, "DyDCNv2 stride 1 with_norm=False")


def test_dcn_routes_by_shape_not_by_failure(monkeypatch):
    """Stride 1 goes through `cuda_deform.deform_conv` (K1 on the card, the
    bias inside it); stride 2 never reaches it, on either device, and
    matches JAX's exact gather at the bias too."""
    calls = []
    real = cuda_deform.deform_conv
    monkeypatch.setattr(cuda_deform, "deform_conv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, off, mask = _dcn_inputs(stride=2)
    w = _t(_x((3, 3, 16, 16), 5) * 0.1)
    bias = _t(_x((16,), 6))
    out = deform.modulated_deform_conv2d(_t(x), _t(off), _t(mask), w, bias, stride=2)
    assert calls == [] and out.shape == (2, 5, 6, 16)
    want = jax.jit(lambda *a: jdeform.modulated_deform_conv2d(*a, stride=2, padding=1,
                                                               method="exact"))(
        *map(jnp.asarray, (x, off, mask, w.numpy(), bias.numpy())))
    _hold(out.numpy(), np.asarray(want), "exact stride 2 with a bias")
    x1, off1, mask1 = _dcn_inputs(stride=1)
    y1 = deform.modulated_deform_conv2d(_t(x1), _t(off1), _t(mask1), w, bias,
                                        semantics="exact")
    assert calls == [1]
    plain = deform.modulated_deform_conv2d_plain(_t(x1), _t(off1), _t(mask1), w, bias, "exact")
    np.testing.assert_array_equal(y1.numpy(), plain.numpy())
    # the exact plain path of any stride is the stride-1 plain version at stride 1
    _hold(deform.modulated_deform_conv2d_exact(_t(x1), _t(off1), _t(mask1), w, bias).numpy(),
          plain.numpy(), "exact path at stride 1")


def test_dcn_bias_gradient_through_the_operator():
    """`with_norm=False` trains its bias through `mgdt::deform_fwd`: the
    gradient of a sum is the number of output pixels per channel."""
    x, off, mask = _dcn_inputs(stride=1)
    m = B.DyDCNv2(16, 16, with_norm=False)
    with torch.no_grad():
        m.weight.copy_(_t(_x((3, 3, 16, 16), 7) * 0.1))
    y = m(*(_t(a).permute(0, 3, 1, 2) for a in (x, off, mask)))
    y.sum().backward()
    np.testing.assert_array_equal(m.bias.grad.numpy(), np.full(16, 2 * 9 * 11, np.float32))
    assert m.weight.grad is not None and torch.isfinite(m.weight.grad).all()
