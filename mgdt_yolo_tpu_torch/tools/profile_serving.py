"""Where the serving path's time goes on the GPU.

    python -m mgdt_yolo_tpu_torch.tools.profile_serving [--batch 32] [--iters 5]

Loads the flagship MGDT-n from `weights/mgdt_n_synth.npz`, Conv+BN fused,
in bf16, and serves a resident batch of synthetic 640 px scenes through
`predict`. Prints, with the card's name and power limit:

* forward, NMS and whole-request times by CUDA events (min over windows);
* a torch.profiler table of device time by kernel over `--iters` requests
  (the 40 largest kernels), the device's busy share of that window, and
  the DCNv2 kernel's share.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..data.synthetic import synthetic_batch
from ..device import resolve_device
from ..engine import predictor
from ..nn.tasks import DetectionModel
from ..ops.nms import non_max_suppression
from ..utils.measure import cuda_time_ms, device_us, gpu_name_and_power

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    dev = resolve_device()
    model = DetectionModel.from_npz(ROOT / "weights" / "mgdt_n_synth.npz",
                                    device=dev).fuse().to(torch.bfloat16)
    x = torch.from_numpy(synthetic_batch(args.batch, 640)).to(dev)
    xf = x.float() / 255.0
    with torch.no_grad():
        decoded, _ = model(xf)
        fwd_ms = cuda_time_ms(lambda: model(xf), iters=10)
        nms_ms = cuda_time_ms(lambda: non_max_suppression(
            decoded, conf_thres=predictor.CONF, iou_thres=predictor.IOU,
            max_det=predictor.MAX_DET, pre_topk=predictor.PRE_TOPK,
            block=predictor.BLOCK), iters=10)
    req_ms = cuda_time_ms(lambda: predictor.predict(model, x), iters=10)
    lines = [f"gpu: {gpu_name_and_power()}",
             f"batch {args.batch} at 640 px, bf16, fused: forward {fwd_ms:.3f} ms, "
             f"NMS {nms_ms:.3f} ms, request {req_ms:.3f} ms "
             f"({args.batch / req_ms * 1e3:.2f} images/s)"]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            predictor.predict(model, x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    kernels.sort(key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in kernels)
    deform_us = sum(device_us(e) for e in kernels if "deform_fwd" in e.key)
    lines.append(f"profiled {args.iters} requests: wall {wall_us / 1e3:.3f} ms, device busy "
                 f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}), idle share "
                 f"{1 - busy_us / wall_us:.1%}; deform_fwd {deform_us / 1e3:.3f} ms "
                 f"({deform_us / max(busy_us, 1e-9):.1%} of device time)")
    lines.append(f"{'device ms/request':>18} {'share':>7} {'calls':>7}  kernel")
    for e in kernels[:40]:
        lines.append(f"{device_us(e) / 1e3 / args.iters:18.4f} "
                     f"{device_us(e) / busy_us:7.1%} {e.count // args.iters:7d}  {e.key[:110]}")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
