#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mgdt_yolo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:

1. environment: torch, CUDA, the card's name and power limit, nvcc, triton;
2. build: nvcc builds every `mgdt_yolo_tpu_torch/csrc/*.cu` (one process per
   source, all started together);
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the main path's shapes, with the stated tolerance, then timed;
4. main path: the flagship MGDT-n from `weights/mgdt_n_synth.npz`, Conv+BN
   fused, bf16, 640 px, answers requests of batch 1, 8 and 32 through
   `predict` on synthetic scenes; every kernel must have launched on it;
5. throughput (images/s) at batch 1, 32 and 128;
6. the same model in float32 on the card and on the CPU (plain DCN): raw
   maps and NMS results must agree. It runs last because the CPU forward
   leaves the host's threads busy, which slows the host-bound batch 1.

The last lines are the kernel table as JSON, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from mgdt_yolo_tpu_torch.data.synthetic import synthetic_batch
from mgdt_yolo_tpu_torch.engine import predictor
from mgdt_yolo_tpu_torch.engine.predictor import predict
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.ops import cuda_deform
from mgdt_yolo_tpu_torch.ops.deform import modulated_deform_conv2d_plain
from mgdt_yolo_tpu_torch.ops.nms import non_max_suppression
from mgdt_yolo_tpu_torch.utils.build import build_all, nvcc_path
from mgdt_yolo_tpu_torch.utils.measure import cuda_time_ms, gpu_name_and_power

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "mgdt_n_synth.npz"
IMGSZ = 640
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12                             # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
# each kernel's launch counter, set to 0 just before the main path
COUNTERS = {"deform_fwd": cuda_deform}


def log(msg=""):
    print(msg, flush=True)


class float32_exact:
    """TF32 off for cuDNN convolutions and matrix products inside the block,
    so float32 on the card is compared as float32."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def phase_environment():
    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    log(f"gpu: {gpu_name_and_power()}")
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60)
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")


def phase_build():
    log("== phase 2: build")
    t0 = time.perf_counter()
    logs = build_all()
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def _deform_inputs(B, H, W, C, O, off_range, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g)
    off = (torch.rand(B, H, W, 18, generator=g) * 2 - 1) * off_range
    mask = torch.rand(B, H, W, 9, generator=g)
    w = (torch.rand(3, 3, C, O, generator=g) * 2 - 1) / (9 * C) ** 0.5
    return [t.to(DEVICE, dtype).contiguous() for t in (x, off, mask, w)]


def _deform_bound_ms(B, H, W, C, O, dtype_name):
    """Least time for the work: each input read once and the output written
    once, against the contraction plus the bilinear sampling operations."""
    esize = 2 if dtype_name == "bfloat16" else 4
    P = H * W
    nbytes = (B * P * (C + 18 + 9 + O) + 9 * C * O) * esize
    flops = 2 * B * P * 9 * C * O + 8 * B * P * 9 * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    """K1 (DCNv2 forward) against its plain version at the main path's
    shape: 80x80 map, C_in = C_out = 32, batch 8."""
    log("== phase 3: kernels against their plain versions")
    B, H, W, C, O = 8, 80, 80, 32, 32
    # float32: both sides accumulate 288 products in float32 in different
    # orders (~1e-6 on outputs of magnitude ~1), so 1e-4 is far above
    # rounding and far below any sampling mistake. bf16: both compute in
    # float32 and round once, so they may differ by one bf16 rounding (2^-8
    # relative) of the largest output; the tolerance is two of those.
    for dtype in (torch.float32, torch.bfloat16):
        for semantics in ("windowed", "exact"):
            for off_range in (1.5, 4.0):
                x, off, mask, w = _deform_inputs(B, H, W, C, O, off_range, dtype)
                with float32_exact():
                    got = cuda_deform.deform_fwd(x, off, mask, w, None, semantics)
                    want = modulated_deform_conv2d_plain(x, off, mask, w, None, semantics)
                    torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                tol = 1e-4 if dtype == torch.float32 else 2 * 2 ** -8 * scale
                ok = bool(torch.isfinite(got).all()) and err <= tol
                log(f"deform_fwd {str(dtype)[6:]:9s} {semantics:8s} offsets +-{off_range}: "
                    f"max_abs_err {err:.3e} (tol {tol:.3e}, max |out| {scale:.3f}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("deform_fwd disagrees with its plain version")
                if dtype == torch.bfloat16 and semantics == "windowed" and off_range == 1.5:
                    # the main path's case: bf16, windowed, offsets in reach
                    main_err = err
                    ms = cuda_time_ms(lambda: cuda_deform.deform_fwd(x, off, mask, w))
                    plain_ms = cuda_time_ms(
                        lambda: modulated_deform_conv2d_plain(x, off, mask, w), iters=5)
                    bound_ms, bound_by = _deform_bound_ms(B, H, W, C, O, "bfloat16")
                    log(f"deform_fwd bf16 windowed B={B}: kernel {ms:.4f} ms, "
                        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return [{"name": "deform_fwd", "route": "cuda",
             "source": "mgdt_yolo_tpu_torch/csrc/deform_fwd.cu",
             "replaces": "mgdt_yolo_tpu/ops/pallas_deform.py:79",
             "shape": f"x ({B},{H},{W},{C}) bf16, weight (3,3,{C},{O}), windowed",
             "launches": None, "max_abs_err": main_err, "max_err": main_err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}]


def phase_main_path():
    log("== phase 4: main path (MGDT-n, fused, bf16, 640 px)")
    model = DetectionModel.from_npz(WEIGHTS, device=DEVICE).fuse().to(torch.bfloat16)
    log(f"deform semantics {model.deform_semantics}, fused {model.n_fused} Conv+BN pairs")
    requests = [synthetic_batch(b, IMGSZ) for b in (1, 8, 32)]
    for counter in COUNTERS.values():
        counter.launches = 0
    results = [predict(model, imgs) for imgs in requests]
    torch.cuda.synchronize()
    launches = {name: counter.launches for name, counter in COUNTERS.items()}
    for imgs, (det, counts) in zip(requests, results):
        b = imgs.shape[0]
        log(f"request b{b}: det {tuple(det.shape)}, detections per image "
            f"min {int(counts.min())} max {int(counts.max())}")
        if det.shape != (b, 300, 6) or not bool(torch.isfinite(det).all()):
            raise SystemExit("main path gave malformed or non-finite detections")
    # at 640 px (twice the weights' training size) some scenes have none
    if sum(int(counts.sum()) for _, counts in results) == 0:
        raise SystemExit("main path found no detections")
    log(f"launches during the main path: {launches}")
    if launches["deform_fwd"] != len(requests):
        raise SystemExit("deform_fwd did not launch exactly once per forward")
    return model, launches


def phase_throughput(model):
    log("== phase 5: throughput (bf16, fused, 640 px, input resident on the card)")
    rates = {}
    for b in (1, 32, 128):
        x = torch.from_numpy(synthetic_batch(b, IMGSZ)).to(DEVICE)
        ms = cuda_time_ms(lambda: predict(model, x), iters=10 if b < 128 else 3)
        rates[f"b{b}"] = b / (ms / 1e3)
        log(f"b{b}: {ms:.3f} ms per batch, {rates[f'b{b}']:.2f} images/s")
    log("throughput images/s: " + json.dumps(rates))


def phase_card_vs_cpu():
    log("== phase 6: float32 on the card against float32 on the CPU")
    # scenes 4 and 5: two that have detections at 640 px
    x = torch.from_numpy(synthetic_batch(6, IMGSZ)[4:]).float() / 255.0
    outs = []
    for dev in (DEVICE, "cpu"):
        model = DetectionModel.from_npz(WEIGHTS, device=dev).fuse()
        with torch.no_grad(), float32_exact():
            decoded, feats = model(x.to(dev))
            det, counts = non_max_suppression(
                decoded, conf_thres=predictor.CONF, iou_thres=predictor.IOU,
                max_det=predictor.MAX_DET, pre_topk=predictor.PRE_TOPK,
                block=predictor.BLOCK)
        outs.append([t.cpu() for t in (feats[0], decoded, det, counts)])
    (fg, dg, detg, cg), (fc, dc, detc, cc) = outs
    raw_err = (fg - fc).abs().max().item()
    dec_err = (dg - dc).abs().max().item()
    same_counts = bool((cg == cc).all())
    box_err = (detg[..., :4] - detc[..., :4]).abs().max().item() if same_counts else None
    log(f"raw map max |diff| {raw_err:.3e} (max |raw| {fc.abs().max().item():.3f}), "
        f"decoded max |diff| {dec_err:.3e}")
    log(f"NMS counts card {cg.tolist()} cpu {cc.tolist()}; box max |diff| {box_err}")
    # float32 without TF32 on both: differences are rounding of reordered sums
    if not (raw_err < 1e-2 and same_counts and int(cc.sum()) > 0 and box_err < 0.5):
        raise SystemExit("the card and the CPU disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    kernels = phase_kernels()
    model, launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise SystemExit(f"kernel {k['name']} never launched on the main path")
    phase_throughput(model)
    phase_card_vs_cpu()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
