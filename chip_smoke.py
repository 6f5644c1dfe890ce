#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mgdt_yolo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:

1. environment: torch, CUDA, the card's name and power limit, nvcc, triton;
2. build: nvcc builds every `mgdt_yolo_tpu_torch/csrc/*.cu` (one process per
   source, all started together: K1, K2 and their SIMT baselines, the K1
   variants on the CUDA cores, the Hopper V2 and V3 `deform_fwd_slab.cu`, the
   Hopper V4, V5 and V1 `deform_fwd_tc_variants.cu`, K3 `fused_augment.cu`
   and its SIMT baseline `fused_augment_simt.cu`, and the check helper
   `smem_poison.cu`), with ptxas's registers and spills, both V1 kernels'
   logged; no instantiation of the Hopper V4, V5 and V1 may spill;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the main paths' shapes, with the stated tolerance: K1 and K2 (the
   tensor-core designs, `csrc/deform_{fwd,bwd}.cu`) in 8 cases (float32 and
   bf16, windowed and exact, offsets +-1.5 and +-4.0) at batch 8 and at the
   training batch, 32, K1 also at b128; in bf16 also by the share of elements
   that differ; their SIMT baselines (`csrc/deform_{fwd,bwd}_simt.cu`) in the
   main case; then each against its SIMT baseline in turns (the "DCN A/B"
   path: K1 at b8, b32 and b128, K2 at b8 and b32), with each time's share
   of its bound and ptxas's registers and spills; K1 and K2 at the widths
   their second plan (the weight staged by tap) takes, C 64 -> 64 at
   (8, 40, 40) and C 128 -> 128 at (4, 20, 20), in the same 8 cases under
   the same limits, with the plan that ran, the shared memory of each plan
   (C 32's must not change) and the widths each kernel documents as its
   limit, then timed in bf16 and float32; K3 (the Hopper design,
   `csrc/fused_augment.cu`) and the SIMT K3 at (32, 640, 640, 3) with
   planted grey, saturated and one-channel pixels, hue-wrapping gains and
   all four flips against the plain version (1e-5), then the Hopper K3
   bitwise against the SIMT K3 over all 2^24 RGB triples (a (1, 4096,
   4096, 3) image) under 4 gain vectors and the 4 flip pairs, and at a
   ragged width, then the two timed in turns (the "K3 A/B" path, counted)
   with each time's share of the bound; the five K1 variants V1-V5 (the
   Hopper V2 and V3 in `csrc/deform_fwd_slab.cu`, V4, V5 and V1 in
   `csrc/deform_fwd_tc_variants.cu`) and their first designs (their `_simt`
   kernels, in `csrc/deform_fwd_variants.cu`) against their plain versions
   at batch 8
   (float32 and bf16, offsets +-1.5 and +-4.0) and at the ragged
   (2, 20, 28, 32 -> 32) and (2, 13, 21, 32 -> 32) (V2-V5 also at their
   tools' check, (2, 16, 24, 8 -> 6), V2 and V3 with and without a bias), in
   bf16 also by the share of elements that differ; both V1 kernels
   against V1's plain version, with the controls that the SIMT and the
   Hopper K1's outputs fail V1's limits and V1's fails K1's, and the Hopper
   V1 within V1's limits of its first design; the Hopper V2-V5 bitwise
   against the Hopper K1 (`deform_fwd`), the first designs of V4 and V5
   against the SIMT K1; V4 and V5 (both designs) also on two inputs where
   V4's skips fire (integer offsets; a mask with whole taps at 0 over
   16-pixel runs) and at C 64 (8, 40, 40), V1 (both designs) at C 64 too,
   with the Hopper V2-V5 and V1's plans (V4's and V1's are the Hopper K1's
   resident plan); the Hopper V1 once more right after every SM's shared
   memory was filled with bf16 NaN bits (`csrc/smem_poison.cu`), on
   out-of-image corners at Cin 24 and 21 (its dead corners and channels past
   Cin must read as zeros); each variant timed beside the SIMT K1; K1 at the
   maps test-time augmentation gives it at 640 px (68x68 and 56x56, C 32:
   the 0.83 and 0.67 passes) in float32 and bf16, windowed, offsets +-1.5
   and +-4.0, at b8, then timed in bf16 at b32 beside its plain version and
   its bound;
4. serving path: the flagship MGDT-n from `weights/mgdt_n_synth.npz`, Conv+BN
   fused, bf16, 640 px, answers requests of batch 1, 8 and 32 through
   `predict` on synthetic scenes; K1 must have launched once per forward,
   and no other kernel;
5. serving throughput (images/s) at batch 1, 32 and 128;
6. training path, unaugmented (`cfg.default.UNAUGMENTED`, no validation):
   the same weights unfused in `train()` mode, bf16 autocast, 640 px, the
   `Trainer` with the JAX defaults (SGD, accumulate 2) over a loader of
   labelled synthetic scenes at batch 32: a few optimizer updates and a
   checkpoint; K1 and K2 must each launch once per micro-step (the SIMT
   kernels and the variants never), every loss be finite and the DCN weight
   get a finite, non-zero gradient;
7. training on one fixed batch: the loss must fall; train images/s at b32;
10. augmented training path: `Trainer.train()` with the JAX defaults
   (`device_augment=True`: mosaic 1.0, scale 0.5, translate 0.1, HSV
   0.015/0.7/0.4; validation with the EMA weights after every epoch), SGD,
   b32, 640 px, 2 epochs of 2 micro-steps, `close_mosaic=1`: K3 and K2 once
   per micro-step (the SIMT K3 never), K1 once per micro-step and once per
   validation forward;
   mosaic in epoch 1 only; augmented boxes inside the image with survivors
   in every batch; finite losses; `results.csv` with 2 finite rows;
   `last.npz` and `best.npz` with the deform pin. Then times the augmented
   against the unaugmented micro-step, `apply_augment` alone and one
   validation pass;
8. serving in float32 on the card and on the CPU (plain DCN): raw maps and
   NMS results must agree;
9. one training step in float32 on the card and on the CPU (plain DCN
   forward and backward), on two seeds' scenes: loss parts and gradients
   must agree; then K2's output with one term planted wrong (d x, the x
   half of d offset, tap 0 of d offset, or d mask dropped) must break the
   gradients' limit;
11. `apply_augment` on the card against the CPU with the same draws, two
   640 px scenes, mosaic on, HSV off and on: labels equal, boxes and
   pixels within the stated tolerance.
13. the ablation family: the seven other models of the paper's ablation
   matrix (`models.CONFIGS`: YOLOv8's PAN with `Detect` at reg_max 4 or
   TOOD on the stride-16 map, and GOLD-YOLO's neck with either head; C2f or
   MSPA-C2f backbones), n-scale, nc=2, full width and depth, 640 px, from
   the port's seeded init (no trained weights exist): each serves a fused
   bf16 request at b8 (K1 once on the three TOOD models, no kernel on the
   four `Detect` models) and is timed at b32; compares a float32 fused
   forward of two noise images on the card with the CPU, its BatchNorm
   statistics set from one batch of scenes (raw maps within 1e-3 of their
   magnitude, decoded boxes 0.5 px, scores 1e-3; NMS on the card and the
   CPU given the same decoded tensor, ~1000 candidates: the same result);
   trains unaugmented through
   `Trainer.train()` at b16 for two micro-steps (accumulate 2: one update;
   K1 and K2 once per micro-step on the TOOD models, none on the others;
   finite losses; a finite, non-zero DCN weight gradient) and reloads its
   `last.npz` through `from_npz` as the same config, `nc` and weights; times
   the micro-step, and K1 and K2 per launch inside the forward and the step
   (torch.profiler) beside phase 3's synthetic C 64 case; on the two thead
   models (DCN at C 64 on the 40x40 map) one float32 training step on the
   card against the CPU, as phase 9 (there K2 runs its streamed plan).
12. K1 variant A/B: the `bench()` of the four ported A/B tools
   (`mgdt_yolo_tpu_torch/tools/proto_deform_*.py`) at their own shapes (b512
   C 32, b128 C 32, b512 C 64, bf16), then all ten variant kernels at the
   training batch (b32, bf16, windowed, +-1.5) in one table against the SIMT
   K1 (the series of earlier runs), then the Hopper V1-V5 in turns against
   their first designs and the Hopper K1 (SIMT V, Hopper V, Hopper K1,
   Hopper K1, Hopper V, SIMT V) at b32, as the tools do at their shapes
   (the slot-skip tool also on inputs where V4's skips fire, the tap-walk
   tool also with V5 under other plans: its warps with one item, the
   Hopper K1's warps with two and with one); each variant must launch
   there, the first designs of V4 and V5 give the SIMT K1's bits, the
   Hopper V2-V5 the Hopper K1's, the Hopper V1 stays within V1's limits of
   its first design (with both controls failing), and the rest stay within
   bf16 rounding of the SIMT K1 (V1's two designs within four roundings);
   the Hopper K1 launches there only as
   the Hopper variants' baseline (its count must equal those runs'), K2
   never; each variant and
   the SIMT K1 are held against their plain versions on the first 8 images
   of each tool's batch (so V5 and K1 at C 64) and on the whole b32 batch,
   as in phase 3.
14. serving entry points: the flagship from the same weights behind
   `DetectionPredictor` (fused, bf16, letterbox to 640 px) over 64 seeded
   BGR scenes of 480x640, 720x1280, 1080x1920 and 375x500, at batch 1 and
   32 and with test-time augmentation at 32 (images/s, per-image
   preprocess and inference ms; K1 once per forward, three times per TTA
   forward, no other kernel), then `InferenceServer` (batch 8, 2 ms wait)
   under 1 and 16 closed-loop client threads, 256 requests each (images/s,
   p50 / p90 latency, mean occupancy; every result equal, bit for bit, to
   the predictor's at batch 8 for its scene; K1 once per batch); then the
   predictor in float32 on the card against the CPU, plain on 16 scenes and
   TTA on 8: the same detections and classes per scene, boxes in the
   scene's pixels within 0.5 px.
15. from disk: the image decoder (`mgdt_yolo_tpu_torch/native`, nvJPEG on
   the card, built in phase 2 beside the kernels) against cv2's decode of
   the committed JPEG fixtures (their PNG twins; one grey, one progressive,
   two EXIF-rotated) within the stated grey-level limit; then a YOLO-format
   dataset written to a temporary directory (64 train and 16 val images
   cut from the seeded scenes at phase 14's four sizes, JPEG through PIL,
   their labels, a dataset YAML),
   decode ms per image at each size; `Trainer(data=...)` with the JAX
   defaults (device augment, validation every epoch, SGD), b32, 640 px, 2
   epochs (K3, K2 and K1 once per micro-step, K1 once per validation
   forward, no other kernel; finite losses; the checkpoint carries the
   dataset's names), `resume=True` for a third epoch (the restored state
   equal to the saved one bit for bit before its first step; the same
   launches), a timed pass of a train loader over the train split four times
   over (images/s from disk
   beside phase 10's resident augmented micro-step, the share of the wall
   time spent waiting for the loader, the device's idle share; then with 8,
   4 and 2 decoder threads in turns), 2 RMSProp
   micro-steps (finite losses); then `DetectionPredictor` (fused, bf16) over
   the val directory at b1 and b32 (K1 once per forward; images/s, decode +
   letterbox ms per image) and the float32 predictor on the card against
   the CPU over 8 of its files (the same detections and classes, boxes
   within 0.5 px).
16. the facade, on phase 15's dataset: `YOLO("weights/mgdt_n_synth.npz")`
   predicting over the val directory (fused, bf16) bit for bit as phase
   15's `DetectionPredictor`, at b1 and b32 in turns with it (images/s;
   K1 once per forward); the float32 facade on the card against the CPU
   over 8 files (phase 15's limits); `cal_model_count_error` and
   `cal_counting_metrics` over the directory in float32 on the card equal
   to the CPU's (counts, TP/FP/FN, MAE/MSE/MAPE, R^2; ms per image); the
   command line in process (`cfg.entrypoint`, K1 counted) and then
   `python -m mgdt_yolo_tpu_torch predict` and `python -m
   mgdt_yolo_tpu_torch.utils.counting --metrics` in their own processes
   (exit code, the per-image detection counts they log, wall time); export
   to npz and pt2 at 640 px and `AutoBackend` over each against the live
   float32 forward at b1 and b8 (bit for bit expected, else within 1e-5 of
   its magnitude; K1 launched once inside each forward of the program), the
   program against the eager float32 module in turns at b1 and b32 (CUDA
   events); `benchmark(formats=["torch", "pt2"])` at b1 and b32; and
   `YOLO(<flagship YAML>).train(data=..., epochs=1)`, `.val()` and
   `.predict()` (K3, K2 and K1 once per micro-step, K1 once per forward).
   Phase 10 runs before phase 8, and phases 8, 9 and 11 run after it,
   because the CPU work leaves the host's threads busy, which slows the
   host-bound steps; phase 13 runs after phase 11, phase 14 after phase
   13, phase 15 after phase 14, phase 16 after phase 15, and phase 12,
   which times kernels only, runs last.

The last lines are the kernel table as JSON, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from mgdt_yolo_tpu_torch.cfg.default import TRAIN_DEFAULTS, UNAUGMENTED
from mgdt_yolo_tpu_torch.data.augment import letterbox
from mgdt_yolo_tpu_torch.data.build import DataLoader, collate, collate_raw, to_device
from mgdt_yolo_tpu_torch import native
from mgdt_yolo_tpu_torch.data.synthetic import (SyntheticDetectionDataset, synthetic_batch,
                                                synthetic_item, synthetic_scene)
from mgdt_yolo_tpu_torch.engine import predictor
from mgdt_yolo_tpu_torch.engine.predictor import (DetectionPredictor, infer, letterbox_batch,
                                                  predict)
from mgdt_yolo_tpu_torch.engine.serve import InferenceServer
from mgdt_yolo_tpu_torch.engine.trainer import Trainer
from mgdt_yolo_tpu_torch.models import CONFIGS, FLAGSHIP
from mgdt_yolo_tpu_torch.nn.modules.block import DyDCNv2
from mgdt_yolo_tpu_torch.nn.tasks import DetectionModel
from mgdt_yolo_tpu_torch.ops import cuda_deform, cuda_deform_variants, cuda_image
from mgdt_yolo_tpu_torch.ops.cuda_deform_variants import (FIRST_DESIGNS, SLAB_KERNELS,
                                                          TC_KERNELS, VARIANTS)
from mgdt_yolo_tpu_torch.ops.deform import (_corners, _sample_fields,
                                            modulated_deform_conv2d_plain,
                                            modulated_deform_conv2d_plain_bwd)
from mgdt_yolo_tpu_torch.ops.deform_variants import (MISMATCH_LIMIT, compare,
                                                     deform_bf16_fma_plain, skip_shares,
                                                     windowed_plain)
from mgdt_yolo_tpu_torch.ops.device_augment import apply_augment, augment_draws
from mgdt_yolo_tpu_torch.ops.image import fused_augment_plain
from mgdt_yolo_tpu_torch.ops.nms import non_max_suppression
from mgdt_yolo_tpu_torch.tools import (deform_ab, proto_deform_bf16_fma, proto_deform_qxhoist,
                                       proto_deform_slot_skip, proto_deform_tapwalk)
from mgdt_yolo_tpu_torch.utils.build import build_all, nvcc_path
from mgdt_yolo_tpu_torch.utils.measure import (HBM_BYTES_PER_S, PEAK_FLOPS, cuda_time_ms,
                                               deform_fwd_bound_ms, device_us,
                                               float32_exact, gpu_name_and_power)

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
WEIGHTS = ROOT / "weights" / "mgdt_n_synth.npz"
IMGSZ = 640
DEVICE = "cuda"
TRAIN_BATCH = 32
# the JAX trainer's defaults, with SGD chosen explicitly; batch 32 gives
# accumulate = round(64 / 32) = 2. Phases 6, 7 and 9 train on unaugmented
# scenes without validation, as they did before the augmented path existed
TRAIN_OVERRIDES = {"optimizer": "SGD", "batch": TRAIN_BATCH, "epochs": 1, "val": False,
                   **UNAUGMENTED}
# phase 10: the JAX defaults (device augment, validation every epoch)
AUG_EPOCHS, AUG_STEPS = 2, 2
AUG_OVERRIDES = {"optimizer": "SGD", "batch": TRAIN_BATCH, "epochs": AUG_EPOCHS,
                 "close_mosaic": 1}
# every variant kernel: the five variants (by their Hopper designs) and
# their first designs, each (wrapper, plain version)
ALL_VARIANTS = {**VARIANTS, **{simt: (fn, plain) for simt, fn, plain in FIRST_DESIGNS.values()}}
# each kernel's launch counter (the dict that holds it, its key), set to 0
# just before a path: a module's globals for K1-K3, the variants' dict
COUNTERS = {"deform_fwd": (vars(cuda_deform), "launches"),
            "deform_bwd": (vars(cuda_deform), "bwd_launches"),
            "deform_fwd_simt": (vars(cuda_deform), "simt_launches"),
            "deform_bwd_simt": (vars(cuda_deform), "bwd_simt_launches"),
            "fused_augment": (vars(cuda_image), "launches"),
            "fused_augment_simt": (vars(cuda_image), "simt_launches"),
            **{name: (cuda_deform_variants.launches, name) for name in ALL_VARIANTS}}
# the TPU function each K1 variant kernel replaces
VARIANT_SITES = {"deform_fwd_bf16_fma": "tools/proto_deform_bf16_fma.py:64",
                 "deform_fwd_bf16_fma_simt": "tools/proto_deform_bf16_fma.py:64",
                 "deform_fwd_qxhoist": "tools/proto_deform_qxhoist.py:163",
                 "deform_fwd_cvt1": "tools/proto_deform_qxhoist.py:128",
                 "deform_fwd_slot_skip": "tools/proto_deform_slot_skip.py:75",
                 "deform_fwd_tapwalk": "tools/proto_deform_tapwalk.py:116",
                 "deform_fwd_qxhoist_simt": "tools/proto_deform_qxhoist.py:163",
                 "deform_fwd_cvt1_simt": "tools/proto_deform_qxhoist.py:128",
                 "deform_fwd_slot_skip_simt": "tools/proto_deform_slot_skip.py:75",
                 "deform_fwd_tapwalk_simt": "tools/proto_deform_tapwalk.py:116"}
# the variants whose design keeps the SIMT K1's order of every float32 sum,
# so they must give its bits (the inputs here are finite): the first designs
# of V4 and V5
BITWISE_TO_K1 = ("deform_fwd_slot_skip_simt", "deform_fwd_tapwalk_simt")
# the variants built on the Hopper K1's design that compute its function,
# and so must give its bits: the Hopper V2-V5 (not V1, whose function is its
# own)
BITWISE_TO_HOPPER_K1 = tuple(k for k in FIRST_DESIGNS if VARIANTS[k][1] is windowed_plain)
# the Hopper variants that compute a function of their own (V1), held to
# their plain version and their first design within `compare`'s limits
OWN_FUNCTION = tuple(k for k in FIRST_DESIGNS if k not in BITWISE_TO_HOPPER_K1)
# each variant kernel's source, by the kernels' names
VARIANT_SOURCES = {**dict.fromkeys(ALL_VARIANTS, "deform_fwd_variants"),
                   **dict.fromkeys(SLAB_KERNELS, "deform_fwd_slab"),
                   **dict.fromkeys(TC_KERNELS, "deform_fwd_tc_variants")}


def reset_counts():
    for holder, key in COUNTERS.values():
        holder[key] = 0


def read_counts():
    return {name: holder[key] for name, (holder, key) in COUNTERS.items()}


def no_launches(**counts):
    """Every counter at 0 but the named ones."""
    return {**dict.fromkeys(COUNTERS, 0), **counts}


def log(msg=""):
    if msg.startswith("== phase"):  # each phase's start, on the script's clock
        msg = f"{msg} [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


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
    logs = build_all()  # the CUDA sources and the image decoder (g++, nvJPEG), together
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    USAGE.update(_ptxas_usage(logs))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"  {name}: {line.strip()}")
    _check_new_kernel_spills(logs)


def _deform_inputs(B, H, W, C, O, off_range, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g)
    off = (torch.rand(B, H, W, 18, generator=g) * 2 - 1) * off_range
    mask = torch.rand(B, H, W, 9, generator=g)
    w = (torch.rand(3, 3, C, O, generator=g) * 2 - 1) / (9 * C) ** 0.5
    return [t.to(DEVICE, dtype).contiguous() for t in (x, off, mask, w)]


def _deform_grad(B, H, W, O, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, H, W, O, generator=g).to(DEVICE, dtype).contiguous()


def _deform_bwd_bound_ms(B, H, W, C, O, dtype_name):
    """K2's least time: read x, offset, mask, weight and the output gradient,
    write d x, d offset, d mask and d weight, each once; against the two
    contractions with the weight (tap gradient, weight gradient) plus the
    sampling work per (pixel, tap, channel, corner): the recomputed sample,
    the corner-weight gradient and the scatter into d x, 2 operations each."""
    esize = 2 if dtype_name == "bfloat16" else 4
    P = H * W
    nbytes = (B * P * ((C + 18 + 9 + O) + (C + 18 + 9)) + 2 * 9 * C * O) * esize
    flops = 2 * (2 * B * P * 9 * C * O) + 4 * 6 * B * P * 9 * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# phase 3's DCN cases: (dtype, semantics, offset range); the main paths' case
# is bf16, windowed, offsets within reach
DCN_CASES = [(dtype, semantics, off_range) for dtype in (torch.float32, torch.bfloat16)
             for semantics in ("windowed", "exact") for off_range in (1.5, 4.0)]
MAIN_CASE = (torch.bfloat16, "windowed", 1.5)
# the batches at which phase 3 holds K1 and K2 in every case (serving's b8
# and the training batch), and at which it times each against its SIMT
# baseline in turns (K1 also at serving's b128)
DCN_BATCHES = (8, TRAIN_BATCH)
AB_BATCHES = {"deform_fwd": (8, TRAIN_BATCH, 128), "deform_bwd": (8, TRAIN_BATCH)}
# ptxas's usage of each kernel's main instantiation, read from the build log
# (phase 2): the name ptxas gives it, registers, spill stores and loads
USAGE = {}
DCN_KERNELS = ("deform_fwd", "deform_fwd_simt", "deform_bwd", "deform_bwd_simt")
# each kernel's symbol and what its main instantiation's mangled name holds:
# the DCN kernels' bf16 one (the Hopper designs' resident plan, K2's
# four-channel lanes), the Hopper K3's four-pixel one
KERNEL_SYMBOLS = {"deform_fwd": ("deform_fwd_mma_kernel", ("bfloat16", "Lb0E")),
                  "deform_fwd_simt": ("deform_fwd_kernel", ("bfloat16",)),
                  "deform_bwd": ("deform_bwd_mma_kernel", ("bfloat16", "Li4E", "Lb0E")),
                  "deform_bwd_simt": ("deform_bwd_kernel", ("bfloat16",)),
                  "fused_augment": ("fused_augment_kernel", ("Lb1E",)),
                  "fused_augment_simt": ("fused_augment_simt_kernel", ()),
                  # the slab kernels on bf16 x: V2's slab in bf16, V3's in float32
                  "deform_fwd_qxhoist": ("slab_kernel", ("deform_fwd_slab_cu",
                                                         "slab_kernelI13__nv_bfloat16S1_E")),
                  "deform_fwd_cvt1": ("slab_kernel", ("deform_fwd_slab_cu",
                                                      "slab_kernelI13__nv_bfloat16fE")),
                  "deform_fwd_qxhoist_simt": ("slab_kernel", ("deform_fwd_variants_cu",
                                                              "slab_kernelI13__nv_bfloat16S1_E")),
                  "deform_fwd_cvt1_simt": ("slab_kernel", ("deform_fwd_variants_cu",
                                                           "slab_kernelI13__nv_bfloat16fE")),
                  # V4 and V5 on bf16 x: the Hopper V5 with one item a warp (C 32's
                  # plan; its two-item instantiation, C 64's, is `_usage`'s "two items")
                  "deform_fwd_slot_skip": ("slot_skip_kernel", ("deform_fwd_tc_variants_cu",
                                                                "bfloat16")),
                  "deform_fwd_tapwalk": ("tapwalk_kernel", ("deform_fwd_tc_variants_cu",
                                                            "bfloat16", "Li1E")),
                  "deform_fwd_slot_skip_simt": ("slot_skip_kernel", ("deform_fwd_variants_cu",
                                                                     "bfloat16")),
                  "deform_fwd_bf16_fma": ("bf16_fma_kernel", ("deform_fwd_tc_variants_cu",
                                                              "bfloat16")),
                  "deform_fwd_bf16_fma_simt": ("bf16_fma_kernel", ("deform_fwd_variants_cu",
                                                                   "bfloat16")),
                  "deform_fwd_tapwalk_simt": ("tapwalk_kernel", ("deform_fwd_variants_cu",
                                                                 "bfloat16"))}


def _ptxas_usage(logs):
    """{function: {"registers": n, "spill_stores": b, "spill_loads": b}} from
    `nvcc -Xptxas -v` output."""
    usage, current = {}, None
    for text in logs.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line) or \
                re.search(r"Function properties for (\S+)", line)
            if m:
                current = m.group(1)
                usage.setdefault(current, {})
            elif current and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                             line)):
                usage[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            elif current and (m := re.search(r"Used (\d+) registers", line)):
                usage[current]["registers"] = int(m.group(1))
    return usage


def _usage(kernel):
    """ptxas's registers and spills of `kernel`'s main instantiation ({}
    for a kernel without an entry in KERNEL_SYMBOLS); for the Hopper V5 also
    those of its two-item instantiation on bf16 x ("two_items")."""
    if kernel not in KERNEL_SYMBOLS:
        return {}
    sym, marks = KERNEL_SYMBOLS[kernel]
    found = {f: u for f, u in USAGE.items()
             if f"{len(sym)}{sym}" in f and all(m in f for m in marks)}
    usage = dict(next(iter(found.values()), {}))
    if kernel == "deform_fwd_tapwalk":
        two = [u for f, u in USAGE.items() if f"{len(sym)}{sym}" in f and "Li2E" in f and
               all(m in f for m in marks[:2])]
        usage["two_items"] = two[0] if two else {}
    return usage


def _check_new_kernel_spills(logs):
    """No instantiation of the Hopper V4, V5 and V1 spills (ptxas's counts
    from phase 2's build `logs`); logs each one's registers, and those of
    V1's first design. Skipped where their library was built before this run
    (no ptxas output to read)."""
    if not logs.get("deform_fwd_tc_variants"):
        log("deform_fwd_tc_variants was built before this run: ptxas's counts not read")
        return
    for kernel in TC_KERNELS:
        sym = KERNEL_SYMBOLS[kernel][0]
        found = {f: u for f, u in USAGE.items()
                 if f"{len(sym)}{sym}" in f and "deform_fwd_tc_variants_cu" in f}
        for f, u in found.items():
            log(f"{kernel} {f}: {u.get('registers')} registers, spill stores "
                f"{u.get('spill_stores')} B, loads {u.get('spill_loads')} B")
        if not found or any(u.get("spill_stores") or u.get("spill_loads")
                            for u in found.values()):
            raise SystemExit(f"{kernel}: an instantiation spills, or ptxas reported none")
    sym = KERNEL_SYMBOLS["deform_fwd_bf16_fma_simt"][0]
    for f, u in USAGE.items():
        if f"{len(sym)}{sym}" in f and "deform_fwd_variants_cu" in f:
            log(f"deform_fwd_bf16_fma_simt {f}: {u.get('registers')} registers, spill stores "
                f"{u.get('spill_stores')} B, loads {u.get('spill_loads')} B")


def _case_label(dtype, semantics, off_range, B):
    return f"{str(dtype)[6:]:9s} {semantics:8s} offsets +-{off_range} B={B}"


def _hold_fwd(name, fn, args, semantics, case):
    """A forward kernel against the plain version on the same inputs, by
    `deform_variants.compare`: float32 1e-4 (both sides accumulate 288
    products in float32 in different orders, ~1e-6 on outputs of magnitude
    ~1; K1's bf16 hi/lo samples keep ~16 bits, ~1e-5); bf16 two bf16
    roundings (2^-8 relative) of the largest output, since both compute in
    float32 and round once, and at most 1% of the elements differing.
    Returns the largest error; ends the script on a disagreement."""
    with float32_exact():
        got = fn(*args, None, semantics)
        want = modulated_deform_conv2d_plain(*args, None, semantics)
        torch.cuda.synchronize()
    c = compare(got, want)
    log(f"{name} {case}: max_abs_err {c['max_abs_err']:.3e} (tol {c['tol']:.3e}), differing "
        f"{c['mismatch_share']:.3%} (limit {c['share_limit']:.0%}) {'ok' if c['ok'] else 'FAIL'}")
    if not c["ok"]:
        raise SystemExit(f"{name} disagrees with its plain version")
    return c["max_abs_err"]


def _hold_bwd(name, fn, args, g, semantics, case):
    """A backward kernel against the plain backward on the same inputs, all
    four gradients; returns the largest error, and ends the script on a
    disagreement."""
    # float32: the kernel's atomics and its per-tile sums reorder float32
    # sums of up to 204800 terms (the weight gradient at batch 32), and K2
    # carries its float32 operands as bf16 hi/lo pairs (~16 bits), so each
    # gradient is held to 1e-4 of its largest value, far above rounding and
    # far below any mistake in the sampling. bf16: both sides round the tap
    # gradient and the samples to bf16 before contracting them and round the
    # results once, so a tap-gradient element on a rounding boundary may
    # round the other way; four bf16 roundings (2^-8 relative) of the
    # largest value, and at most 1% of each gradient's elements differing
    # (sums in another order move an element across a bf16 rounding edge
    # rarely; another function moves about half of them).
    with float32_exact():
        got = fn(*args, g, semantics)
        want = modulated_deform_conv2d_plain_bwd(*args, g, semantics)
        torch.cuda.synchronize()
    errs = []
    for gname, a, b in zip(("dx", "d_offset", "d_mask", "d_weight"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        share = (a != b).float().mean().item()
        f32 = g.dtype == torch.float32
        tol = (1e-4 if f32 else 4 * 2 ** -8) * scale
        limit = 1.0 if f32 else MISMATCH_LIMIT
        ok = bool(torch.isfinite(a).all()) and a.dtype == b.dtype and err <= tol and \
            share <= limit
        errs.append(err)
        log(f"{name} {case} {gname:8s}: max_abs_err {err:.3e} (tol {tol:.3e}, max "
            f"{scale:.3f}), differing {share:.3%} (limit {limit:.0%}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version")
    return max(errs)


def _check_dcn(H, W, C, O):
    """K1 and K2 in the 8 cases at each of DCN_BATCHES, K1 also in the main
    case at b128; the SIMT kernels in the main case at each batch. Returns
    the largest error of each kernel in the main case, by batch."""
    errs = {k: {} for k in DCN_KERNELS}
    for B in DCN_BATCHES:
        for dtype, semantics, off_range in DCN_CASES:
            args = _deform_inputs(B, H, W, C, O, off_range, dtype)
            g = _deform_grad(B, H, W, O, dtype)
            case = _case_label(dtype, semantics, off_range, B)
            main = (dtype, semantics, off_range) == MAIN_CASE
            kernels = [("deform_fwd", cuda_deform.deform_fwd, _hold_fwd),
                       ("deform_bwd", cuda_deform.deform_bwd, _hold_bwd)]
            if main:
                kernels += [("deform_fwd_simt", cuda_deform.deform_fwd_simt, _hold_fwd),
                            ("deform_bwd_simt", cuda_deform.deform_bwd_simt, _hold_bwd)]
            for name, fn, hold in kernels:
                extra = (g,) if hold is _hold_bwd else ()
                err = hold(name, fn, args, *extra, semantics, case)
                if main:
                    errs[name][B] = err
            del args, g
    args = _deform_inputs(128, H, W, C, O, 1.5, torch.bfloat16)
    errs["deform_fwd"][128] = _hold_fwd("deform_fwd", cuda_deform.deform_fwd, args, "windowed",
                                        _case_label(*MAIN_CASE, 128))
    return errs


# the maps K1 takes under test-time augmentation at 640 px (phase 14): the
# 0.83 and 0.67 passes give 544 and 448 px inputs, so 68x68 and 56x56
# stride-8 maps at the flagship's C 32; held at b8, timed at phase 14's batch
TTA_MAPS = ((68, 68), (56, 56))
TTA_BATCH = 32


def _check_tta_maps(C=32, O=32):
    """K1 at TTA's maps against its plain version (float32 and bf16,
    windowed, offsets +-1.5 and +-4.0, b8, `_hold_fwd`'s limits), then
    timed in bf16 at the TTA batch beside its plain version and bound.
    Returns {"HxW": {errors, ms, plain_ms, bound_ms, bound_by}}."""
    out = {}
    for H, W in TTA_MAPS:
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            for off in (1.5, 4.0):
                args = _deform_inputs(8, H, W, C, O, off, dtype)
                row[f"max_abs_err_{str(dtype)[6:]}_{off}"] = _hold_fwd(
                    "deform_fwd", cuda_deform.deform_fwd, args, "windowed",
                    f"{_case_label(dtype, 'windowed', off, 8)} {H}x{W}")
        args = _deform_inputs(TTA_BATCH, H, W, C, O, 1.5, torch.bfloat16)
        row["ms"] = cuda_time_ms(lambda: cuda_deform.deform_fwd(*args), iters=10, windows=3)
        row["plain_ms"] = cuda_time_ms(lambda: modulated_deform_conv2d_plain(*args),
                                       iters=2, windows=2)
        row["bound_ms"], row["bound_by"] = deform_fwd_bound_ms(TTA_BATCH, H, W, C, O,
                                                               "bfloat16")
        log(f"deform_fwd TTA map b{TTA_BATCH} {H}x{W} bf16 windowed: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.2%} of it")
        out[f"{H}x{W}"] = row
        del args
    return out


# the widths K1's and K2's second plan takes: (B, H, W, C -> C), the thead
# YAMLs' DCN on the stride-16 map at 640 px and a C 128 map
WIDE_SHAPES = ((8, 40, 40, 64), (4, 20, 20, 128))
# what each kernel's resident plan needs at C 32 -> 32 (80-wide map for K2),
# as it did before the second plan existed: the flagship's plan must not move
C32_SMEM = {("deform_fwd", 0): 219648, ("deform_fwd", 1): 225280,
            ("deform_bwd", 0): 186752, ("deform_bwd", 1): 229600}
# the largest square C each kernel documents (`ops/cuda_deform.py`), by
# type (bf16 flag), K2's at every map width
WIDTH_LIMITS = {("deform_fwd", 0): 172, ("deform_fwd", 1): 256,
                ("deform_bwd", 0): 144, ("deform_bwd", 1): 194}


def _check_plans():
    """The plans' shared memory at C 32 is C32_SMEM's, and each kernel takes
    its documented largest C and refuses the next (K2 at widths 20, 21,
    40, 80 and 640)."""
    for (name, bf16), want in C32_SMEM.items():
        shape = {"Cin": 32, "Cout": 32, "bf16": bf16, "W": 80}
        got = cuda_deform._kernel_smem(name, **shape)
        log(f"{name} C 32 {'bf16' if bf16 else 'float32'}: plan "
            f"{cuda_deform.plan(name, **shape)}, {got} B of shared memory (expected {want} B)")
        if got != want or cuda_deform.plan(name, **shape) != "resident":
            raise SystemExit(f"{name}'s plan at C 32 changed")
    for (name, bf16), top in WIDTH_LIMITS.items():
        # K2's limit is its least over widths, reached at width 21
        widths, edge = ((80,), 80) if name == "deform_fwd" else ((20, 21, 40, 80, 640), 21)
        for W in widths:
            smem = cuda_deform._kernel_smem(name, Cin=top, Cout=top, bf16=bf16, W=W)
            ok = 0 < smem <= cuda_deform._MAX_SMEM
            log(f"{name} {'bf16' if bf16 else 'float32'} C {top} W {W}: plan "
                f"{cuda_deform.plan(name, Cin=top, Cout=top, bf16=bf16, W=W)}, {smem} B "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} does not take its documented C {top}")
        over = cuda_deform._kernel_smem(name, Cin=top + 1, Cout=top + 1, bf16=bf16, W=edge)
        log(f"{name} {'bf16' if bf16 else 'float32'} C {top + 1} W {edge}: {over} B "
            f"(refused: {over < 0})")
        if over >= 0:
            raise SystemExit(f"{name} takes C {top + 1}, above its documented limit")


def _check_dcn_wide():
    """K1 and K2 at WIDE_SHAPES in the 8 cases, under the same limits, with
    the plan each ran; then each timed in bf16 and float32 (windowed,
    offsets +-1.5). Returns {kernel: {"C<C>": row}}."""
    out = {"deform_fwd": {}, "deform_bwd": {}}
    for B, H, W, C in WIDE_SHAPES:
        errs = {"deform_fwd": 0.0, "deform_bwd": 0.0}
        plans = {}
        for dtype, semantics, off_range in DCN_CASES:
            bf16 = int(dtype == torch.bfloat16)
            for name in errs:
                plans[(name, bf16)] = cuda_deform.plan(name, Cin=C, Cout=C, bf16=bf16, W=W)
            args = _deform_inputs(B, H, W, C, C, off_range, dtype)
            g = _deform_grad(B, H, W, C, dtype)
            case = f"{_case_label(dtype, semantics, off_range, B)} ({H}x{W}, C {C} -> {C})"
            errs["deform_fwd"] = max(errs["deform_fwd"], _hold_fwd(
                "deform_fwd", cuda_deform.deform_fwd, args, semantics, case))
            errs["deform_bwd"] = max(errs["deform_bwd"], _hold_bwd(
                "deform_bwd", cuda_deform.deform_bwd, args, g, semantics, case))
            del args, g
        bounds = {"deform_fwd": deform_fwd_bound_ms, "deform_bwd": _deform_bwd_bound_ms}
        for name, fn in (("deform_fwd", cuda_deform.deform_fwd),
                         ("deform_bwd", cuda_deform.deform_bwd)):
            row = {"shape": f"({B},{H},{W},{C}->{C})", "max_abs_err": errs[name]}
            for dtype in (torch.bfloat16, torch.float32):
                dname, bf16 = str(dtype)[6:], int(dtype == torch.bfloat16)
                args = _deform_inputs(B, H, W, C, C, 1.5, dtype)
                if name == "deform_bwd":
                    args.append(_deform_grad(B, H, W, C, dtype))
                with float32_exact():
                    ms = cuda_time_ms(lambda: fn(*args), iters=10, windows=3)
                bound_ms, bound_by = bounds[name](B, H, W, C, C, dname)
                smem = cuda_deform._kernel_smem(name, Cin=C, Cout=C, bf16=bf16, W=W)
                row[dname] = {"plan": plans[(name, bf16)], "smem": smem, "ms": ms,
                              "bound_ms": bound_ms, "bound_by": bound_by}
                log(f"{name} ({B},{H},{W},{C}->{C}) {dname} windowed: plan "
                    f"{plans[(name, bf16)]} ({smem} B), {ms:.4f} ms, bound {bound_ms:.5f} ms "
                    f"({bound_by}), at {bound_ms / ms:.2%} of it")
                del args
            out[name][f"C{C}"] = row
        torch.cuda.empty_cache()
    return out


def _dcn_ab(H, W, C, O):
    """Each Hopper DCN kernel against its SIMT baseline in the main case, in
    turns (SIMT, Hopper, Hopper, SIMT; min of each, CUDA events), at
    AB_BATCHES, with the plain version's time and the bound. Returns
    {kernel: {B: row}}."""
    pairs = {"deform_fwd": (cuda_deform.deform_fwd, cuda_deform.deform_fwd_simt,
                            modulated_deform_conv2d_plain, deform_fwd_bound_ms),
             "deform_bwd": (cuda_deform.deform_bwd, cuda_deform.deform_bwd_simt,
                            modulated_deform_conv2d_plain_bwd, _deform_bwd_bound_ms)}
    rows = {}
    for name, (new, simt, plain, bound) in pairs.items():
        usage, simt_usage = _usage(name), _usage(f"{name}_simt")
        rows[name] = {}
        for B in AB_BATCHES[name]:
            args = _deform_inputs(B, H, W, C, O, 1.5, torch.bfloat16)
            if name == "deform_bwd":
                args.append(_deform_grad(B, H, W, O, torch.bfloat16))
            iters = max(2, 160 // B)
            times = {"new": [], "simt": []}
            for who in ("simt", "new", "new", "simt"):
                fn = new if who == "new" else simt
                times[who].append(cuda_time_ms(lambda: fn(*args), iters=iters, windows=3))
            ms, simt_ms = min(times["new"]), min(times["simt"])
            plain_ms = cuda_time_ms(lambda: plain(*args), iters=2, windows=2)
            bound_ms, bound_by = bound(B, H, W, C, O, "bfloat16")
            rows[name][B] = {"ms": ms, "simt_ms": simt_ms, "ratio": simt_ms / ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"A/B {name} b{B} bf16 windowed: SIMT " +
                " / ".join(f"{t:.4f}" for t in times["simt"]) + " ms, Hopper " +
                " / ".join(f"{t:.4f}" for t in times["new"]) +
                f" ms; SIMT / Hopper {simt_ms / ms:.3f}x; bound {bound_ms:.5f} ms ({bound_by}): "
                f"Hopper at {bound_ms / ms:.2%} of it, SIMT at {bound_ms / simt_ms:.2%}; plain "
                f"{plain_ms:.4f} ms; registers / spill stores Hopper {usage.get('registers')} / "
                f"{usage.get('spill_stores')} B, SIMT {simt_usage.get('registers')} / "
                f"{simt_usage.get('spill_stores')} B")
            del args
        torch.cuda.empty_cache()
    return rows


def _dcn_entries(H, W, C, O, errs, rows):
    """The kernels line's entries of K1, K2 and their SIMT baselines: each
    timed at b8 (`ms`) and at the other A/B batches (`ms_b<B>`)."""
    sites = {"deform_fwd": "mgdt_yolo_tpu/ops/pallas_deform.py:79",
             "deform_bwd": "mgdt_yolo_tpu/ops/pallas_deform.py:195"}
    entries = []
    for name in ("deform_fwd", "deform_bwd"):
        for kernel, key in ((name, "ms"), (f"{name}_simt", "simt_ms")):
            by_b = rows[name]
            e = {"name": kernel, "route": "cuda",
                 "source": f"mgdt_yolo_tpu_torch/csrc/{kernel}.cu", "replaces": sites[name],
                 "shape": f"x (8,{H},{W},{C}) bf16, weight (3,3,{C},{O}), windowed",
                 "launches": None, "max_abs_err": errs[kernel][8], "max_err": errs[kernel][8],
                 "ms": by_b[8][key], "plain_ms": by_b[8]["plain_ms"],
                 "bound_ms": by_b[8]["bound_ms"], "bound_by": by_b[8]["bound_by"],
                 "library_ms": None, **_usage(kernel)}
            for B, row in by_b.items():
                if B != 8:
                    e.update({f"ms_b{B}": row[key], f"plain_ms_b{B}": row["plain_ms"],
                              f"bound_ms_b{B}": row["bound_ms"]})
                if B in errs[kernel] and B != 8:
                    e[f"max_abs_err_b{B}"] = errs[kernel][B]
            if kernel == name:
                e["simt_over_hopper"] = {f"b{B}": row["ratio"] for B, row in by_b.items()}
            entries.append(e)
    return entries


# K3's float32 operations per pixel, the function's own (csrc/fused_augment_simt.cu): 3
# divisions by 255; max and min of three (4); delta (2); the hue branch (3)
# and /6 (1); s (2); the hue gain and its floor-mod (2); the saturation and
# value gains and their clips (6); h6 and c (2); xx (5); m (1); the sector
# (2); the zero (1); three 5-step picks (15); the three + m (3); the two
# branch compares (2)
K3_OPS_PER_PIXEL = 54


def _augment_inputs(B, H, W, seed=0):
    """K3's inputs on the card: random uint8 with planted grey, black,
    white, saturated and one-channel-max pixels; gains drawn as the trainer
    draws them for even images and pushing hue across the wrap (gain 1.5 to
    3.7) for odd ones; the four flip combinations in turn."""
    g = torch.Generator().manual_seed(seed)
    imgs = torch.randint(0, 256, (B, H, W, 3), generator=g, dtype=torch.uint8)
    planted = [(v, v, v) for v in (0, 1, 17, 128, 254, 255)] + [
        (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (0, 255, 255), (255, 0, 255),
        (200, 200, 10), (10, 200, 200), (200, 10, 200), (255, 1, 0), (255, 0, 1), (1, 0, 255)]
    for j, px in enumerate(planted):
        rows = torch.arange(j, H, len(planted))
        imgs[:, rows, (7 * j) % W] = torch.tensor(px, dtype=torch.uint8)
        imgs[:, (3 * j) % H, j::len(planted)] = torch.tensor(px, dtype=torch.uint8)
    gains = augment_draws(B, W, g)["gains"]
    gains[1::2] = 1.0 + torch.rand(B // 2, 3, generator=g) * torch.tensor([2.7, 0.7, 0.4])
    gains[1::2, 0] += 0.5
    flips = torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=torch.int32).repeat(B, 1)[:B]
    return [t.to(DEVICE).contiguous() for t in (imgs, gains, flips)]


K3_KERNELS = {"fused_augment": cuda_image.fused_augment,
              "fused_augment_simt": cuda_image.fused_augment_simt}


def _bits(t):
    """A float32 tensor's bits, so -0 and +0 (and NaN payloads) differ."""
    return t.contiguous().view(torch.int32)


def _k3_exhaustive():
    """The Hopper K3 against the SIMT K3, bit for bit, over every RGB triple:
    a (1, 4096, 4096, 3) image holding the 2^24 triples once, under 4 gain
    vectors (identity, a trainer draw, (1.015, 1.7, 0.6), the hue-wrapping
    (3.7, 1.0, 1.0)) and the 4 flip pairs; then at a ragged width (the
    pixel-per-thread path) under the same gains and flips."""
    idx = torch.arange(1 << 24, device=DEVICE, dtype=torch.int32)
    full = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255], dim=-1).to(torch.uint8)
    full = full.view(1, 4096, 4096, 3).contiguous()
    draw = augment_draws(1, IMGSZ, torch.Generator().manual_seed(0))["gains"][0]
    gain_rows = [torch.ones(3), draw, torch.tensor([1.015, 1.7, 0.6]),
                 torch.tensor([3.7, 1.0, 1.0])]
    ragged = torch.randint(0, 256, (4, 37, 41, 3), generator=torch.Generator().manual_seed(1),
                           dtype=torch.uint8).to(DEVICE)
    n_checked, worst = 0, 0.0
    for gains in gain_rows:
        for flip in ((0, 0), (1, 0), (0, 1), (1, 1)):
            for imgs in (full, ragged):
                B = imgs.shape[0]
                gv = gains.to(DEVICE, torch.float32).reshape(1, 3).repeat(B, 1).contiguous()
                fv = torch.tensor([flip] * B, dtype=torch.int32, device=DEVICE)
                new = cuda_image.fused_augment(imgs, gv, fv)
                old = cuda_image.fused_augment_simt(imgs, gv, fv)
                same = torch.equal(_bits(new), _bits(old))
                worst = max(worst, (new - old).abs().max().item())
                n_checked += 1
                if not same:
                    raise SystemExit(f"the Hopper K3 differs from the SIMT K3 at gains "
                                     f"{gains.tolist()}, flips {flip}, shape "
                                     f"{tuple(imgs.shape)}: max |d| {worst:.3e}")
                del new, old
    log(f"fused_augment vs fused_augment_simt: bitwise equal over all 2^24 RGB triples x "
        f"{len(gain_rows)} gain vectors x 4 flip pairs, and at (4, 37, 41, 3) "
        f"({n_checked} launches each, max |d| {worst:.1e})")
    del full, ragged
    torch.cuda.empty_cache()
    return worst


def _check_augment(B, H, W):
    """Both K3 designs against the plain version at the augmented training
    path's shape, the Hopper K3 bitwise against the SIMT K3 over every RGB
    triple, then the two timed in turns (SIMT, Hopper, Hopper, SIMT; min of
    each), the counted "K3 A/B" path. Returns the kernels line's entries
    and the A/B's launches."""
    imgs, gains, flips = _augment_inputs(B, H, W)
    want = fused_augment_plain(imgs, gains, flips)
    # both compute float32 from the same uint8 values in the same order; the
    # kernels round every operation (no FMA contraction), PyTorch may divide
    # by 255 as a product with 1/255 (a last bit apart) and moves nothing
    # else; the output is continuous across the hue sectors, so a last-bit
    # move of h6 at a sector edge stays a last-bit move: 1e-5 absolute
    tol = 1e-5
    errs, outs = {}, {}
    for name, fn in K3_KERNELS.items():
        got = outs[name] = fn(imgs, gains, flips)
        torch.cuda.synchronize()
        err = errs[name] = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and got.dtype == torch.float32 and err <= tol
        log(f"{name} ({B},{H},{W},3) uint8: max_abs_err {err:.3e} (tol {tol:.0e}), "
            f"hue gains {gains[:, 0].min().item():.3f} to {gains[:, 0].max().item():.3f}, "
            f"output in [{got.min().item():.4f}, {got.max().item():.4f}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version")
    if not torch.equal(_bits(outs["fused_augment"]), _bits(outs["fused_augment_simt"])):
        raise SystemExit("the Hopper K3 differs from the SIMT K3 on the planted inputs")
    del outs, want
    _k3_exhaustive()

    reset_counts()
    times = {name: [] for name in K3_KERNELS}
    for name in ("fused_augment_simt", "fused_augment", "fused_augment", "fused_augment_simt"):
        fn = K3_KERNELS[name]
        times[name].append(cuda_time_ms(lambda: fn(imgs, gains, flips)))
    torch.cuda.synchronize()
    ab_launches = read_counts()
    ms = {name: min(t) for name, t in times.items()}
    plain_ms = cuda_time_ms(lambda: fused_augment_plain(imgs, gains, flips), iters=5)
    nbytes = imgs.numel() * 5 + gains.numel() * 4 + flips.numel() * 4   # 3 B in, 12 B out
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = B * H * W * K3_OPS_PER_PIXEL / PEAK_FLOPS["float32"]
    bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    new, simt = ms["fused_augment"], ms["fused_augment_simt"]
    usage, simt_usage = _usage("fused_augment"), _usage("fused_augment_simt")
    log(f"A/B fused_augment ({B},{H},{W},3): SIMT " +
        " / ".join(f"{t:.4f}" for t in times["fused_augment_simt"]) + " ms, Hopper " +
        " / ".join(f"{t:.4f}" for t in times["fused_augment"]) +
        f" ms; SIMT / Hopper {simt / new:.3f}x; bound {bound_ms:.5f} ms ({bound_by}; "
        f"{nbytes / 1e6:.1f} MB): Hopper at {bound_ms / new:.2%} of it, SIMT at "
        f"{bound_ms / simt:.2%}; plain {plain_ms:.4f} ms; registers / spill stores Hopper "
        f"{usage.get('registers')} / {usage.get('spill_stores')} B, SIMT "
        f"{simt_usage.get('registers')} / {simt_usage.get('spill_stores')} B")
    log(f"launches during the K3 A/B path: {ab_launches}")
    entries = []
    for name in K3_KERNELS:
        e = {"name": name, "route": "cuda", "source": f"mgdt_yolo_tpu_torch/csrc/{name}.cu",
             "replaces": "mgdt_yolo_tpu/ops/pallas_image.py:93",
             "shape": f"images ({B},{H},{W},3) uint8 -> float32, gains ({B},3), flips ({B},2)",
             "launches": None, "max_abs_err": errs[name], "max_err": errs[name],
             "ms": ms[name], "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None, "share_of_bound": bound_ms / ms[name],
             **_usage(name)}
        if name == "fused_augment":
            e.update(simt_over_hopper=simt / new, bitwise_to_simt=True)
        entries.append(e)
    return entries, ab_launches


def _check_variant_case(shape, dtype, off_range, bitwise):
    """The ten variant kernels in one case against their plain versions, by
    `deform_variants.compare` (K1's tolerances, and in bf16 the share of
    elements that may differ), and against the SIMT K1's output ("K1"
    below, the baseline of the first designs): the first designs of V4 and
    V5 must equal it bit for bit, and the Hopper V2-V5 the Hopper K1's
    output; each prints its largest difference from K1 relative to K1's
    largest output, the number the JAX tool prints. Both V1 kernels are held
    by `_hold_own`. Returns each variant's error and records in `bitwise`
    whether V2-V5 gave their bitwise reference's bits (K1's for the others)."""
    args = _deform_inputs(*shape, off_range, dtype)
    case = f"{str(dtype)[6:]:9s} offsets +-{off_range} {shape}"
    errs = {}
    with float32_exact():
        k1 = cuda_deform.deform_fwd_simt(*args)
        hopper_k1 = cuda_deform.deform_fwd(*args)
        want = windowed_plain(*args)
        for name, (fn, plain) in ALL_VARIANTS.items():
            if plain is not windowed_plain:
                continue
            got = fn(*args)
            torch.cuda.synchronize()
            c = compare(got, want)
            hopper = name in BITWISE_TO_HOPPER_K1
            ref = "the Hopper K1" if hopper else "K1"
            same = torch.equal(got, hopper_k1 if hopper else k1)
            rel = (got.float() - k1.float()).abs().max().item() / k1.float().abs().max().item()
            ok = c["ok"] and (same or name not in BITWISE_TO_K1 + BITWISE_TO_HOPPER_K1)
            log(f"{name:25s} {case}: max_abs_err {c['max_abs_err']:.3e} "
                f"(tol {c['tol']:.3e}), differing {c['mismatch_share']:.3%} "
                f"(limit {c['share_limit']:.0%}), "
                f"{f'bitwise equal to {ref}' if same else f'differs from {ref}'}, "
                f"max rel diff from K1 {rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version or with K1")
            errs[name] = c["max_abs_err"]
            bitwise[name] = bitwise.get(name, True) and same
    errs.update(_hold_own(args, case, k1=k1, hopper_k1=hopper_k1))
    return errs


def _hold_own(args, case, k1=None, hopper_k1=None):
    """Both designs of each variant that computes a function of its own
    (V1, OWN_FUNCTION) on `args`, by `deform_ab.hold_hopper` on the whole
    batch: each within V1's limits of its plain version, the Hopper V1
    within them of its first design, and the controls that tell V1's
    function from K1's failing: the Hopper K1's output (`hopper_k1`,
    computed where not given) and the SIMT K1's (`k1`, where given) against
    V1's plain version, both V1 designs' outputs against K1's. Ends the
    script on a failure; returns each kernel's largest error from its plain
    version."""
    errs = {}
    if hopper_k1 is None:
        hopper_k1 = cuda_deform.deform_fwd(*args)
    for name in OWN_FUNCTION:
        held = deform_ab.hold_hopper(name, VARIANTS[name][0](*args), hopper_k1, args,
                                     plain_images=args[0].shape[0],
                                     others=None if k1 is None else {"the SIMT K1": k1})
        log(f"{name:25s} {case}: {held['text']} {'ok' if held['ok'] else 'FAIL'}")
        if not held["ok"]:
            raise SystemExit(f"{name} or its first design disagrees with its plain version or "
                             "with each other, or the limits do not tell V1's function from K1's")
        errs[name] = held["plain"]["max_abs_err"]
        errs[FIRST_DESIGNS[name][0]] = held["first_design_plain"]["max_abs_err"]
    return errs


def _check_hopper_plans(shapes):
    """The Hopper V1-V5's plans at `shapes` in both types, each logged, with
    the kernel's own count of the plan's shared memory, which must be the
    plan's (the launch refuses a plan it disagrees with); V4's and V1's must
    be the Hopper K1's resident plan, byte for byte, where K1 takes that
    plan (V1's with the A-block bytes its bf16 path leaves unused)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, H, W, C, O in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for kernel in SLAB_KERNELS:
                if C > 32:  # no slab plan fits at C 64 on width 40 or 80
                    continue
                plan = cuda_deform_variants.slab_plan(kernel, B, H, W, C, O, dtype, sms)
                own = cuda_deform_variants.slab_smem_bytes(plan, W, C, O, dtype)
                log(f"{kernel} {str(dtype)[6:]} ({B},{H},{W},{C}->{O}): RB {plan['rb']}, ring "
                    f"{plan['ring_rows']} rows, {plan['warps']} warps, {plan['blocks']} blocks "
                    f"for {plan['bands']} bands, {plan['smem']} B (the kernel's count {own} B)")
                if own != plan["smem"]:
                    raise SystemExit(f"{kernel}'s plan and its kernel disagree on its bytes")
            k1 = cuda_deform_variants.hopper_k1_plan(C, O, dtype)
            for kernel in TC_KERNELS:
                plan = cuda_deform_variants.tc_plan(kernel, B, H, W, C, O, dtype, sms)
                own = cuda_deform_variants.tc_smem_bytes(plan, C, O, dtype)
                unused = f", {plan['unused_a_bytes']} B of them unused" \
                    if plan["unused_a_bytes"] else ""
                log(f"{kernel} {str(dtype)[6:]} ({B},{H},{W},{C}->{O}): {plan['warps']} warps x "
                    f"{plan['items_per_warp']} items, {plan['blocks']} blocks for "
                    f"{plan['items']} items, {plan['smem']} B (the kernel's count {own} B"
                    f"{unused}); the Hopper K1 {k1['plan']}, {k1['warps']} warps, "
                    f"{k1['smem']} B")
                if own != plan["smem"]:
                    raise SystemExit(f"{kernel}'s plan and its kernel disagree on its bytes")
                if kernel != "deform_fwd_tapwalk" and k1["plan"] == "resident" and \
                        (plan["warps"], plan["smem"]) != (k1["warps"], k1["smem"]):
                    raise SystemExit(f"{kernel}'s plan is not the Hopper K1's resident plan")


# the C 64 shape at which the Hopper V4 and V5 and their first designs are
# held too: K1's (8, 40, 40) of phase 3's widths
VARIANT_WIDE = (8, 40, 40, 64, 64)
# V4's and V5's kernels and the K1 whose bits each must give
SKIP_AND_WALK = {"deform_fwd_slot_skip": cuda_deform.deform_fwd,
                 "deform_fwd_tapwalk": cuda_deform.deform_fwd,
                 "deform_fwd_slot_skip_simt": cuda_deform.deform_fwd_simt,
                 "deform_fwd_tapwalk_simt": cuda_deform.deform_fwd_simt}


def _hold_bits(name, args, case, bitwise):
    """One of SKIP_AND_WALK against its plain version (`compare`) and bit
    for bit against its K1 on `args`; ends the script on a disagreement.
    Returns the largest error."""
    fn, plain = ALL_VARIANTS[name]
    with float32_exact():
        got, ref, want = fn(*args), SKIP_AND_WALK[name](*args), plain(*args)
        torch.cuda.synchronize()
    c = compare(got, want)
    same = torch.equal(got, ref)
    k1 = "the Hopper K1" if SKIP_AND_WALK[name] is cuda_deform.deform_fwd else "the SIMT K1"
    log(f"{name:25s} {case}: max_abs_err {c['max_abs_err']:.3e} (tol {c['tol']:.3e}), differing "
        f"{c['mismatch_share']:.3%}, {'bitwise equal to' if same else 'DIFFERS from'} {k1} "
        f"{'ok' if c['ok'] and same else 'FAIL'}")
    if not (c["ok"] and same):
        raise SystemExit(f"{name} disagrees with its plain version or with {k1}")
    bitwise[name] = bitwise.get(name, True) and same
    return c["max_abs_err"]


def _skip_inputs(kind, B, H, W, C, O, dtype):
    """Inputs on which V4's skips fire (`deform_ab.skip_firing`; checks of
    the skip's bits, not user traffic): "integer offsets", U(-2.5, 2.5)
    rounded; "dead taps", offsets U(-1.5, 1.5) and a third of the (item,
    tap) pairs' mask 0."""
    off_range = 2.5 if kind == "integer offsets" else 1.5
    x, off, mask, w = _deform_inputs(B, H, W, C, O, off_range, torch.float32)
    off, mask = deform_ab.skip_firing(kind, off, mask)
    return [t.to(dtype).contiguous() for t in (x, off, mask, w)]


def _check_skip_and_walk(B, H, W, C, O, bitwise):
    """V4 and V5, both designs, where V4's skips fire (SKIP_CASES, each in
    float32 and bf16, the share of corners and (item, tap) pairs skipped
    logged) and at VARIANT_WIDE in the 4 windowed cases, each bit for bit
    its K1 and within `compare` of the plain version."""
    for kind in ("integer offsets", "dead taps"):
        for dtype in (torch.float32, torch.bfloat16):
            args = _skip_inputs(kind, B, H, W, C, O, dtype)
            skips = skip_shares(args[1], args[2])
            log(f"skip check ({kind}, {str(dtype)[6:]}; a check of V4's skips, not user "
                f"traffic): V4 skips {skips['zero_corners']:.2%} of the corners K1 gathers, "
                f"{skips['dead_taps']:.2%} of the (item, tap) pairs")
            if skips["zero_corners" if kind == "integer offsets" else "dead_taps"] < 0.25:
                raise SystemExit(f"the {kind} case does not make V4's skips fire")
            for name in SKIP_AND_WALK:
                _hold_bits(name, args, f"{kind} {str(dtype)[6:]} ({B},{H},{W},{C}->{O})",
                           bitwise)
            del args
    B, H, W, C, O = VARIANT_WIDE
    for dtype in (torch.float32, torch.bfloat16):
        for off_range in (1.5, 4.0):
            args = _deform_inputs(B, H, W, C, O, off_range, dtype)
            for name in SKIP_AND_WALK:
                _hold_bits(name, args, f"{_case_label(dtype, 'windowed', off_range, B)} "
                           f"({H}x{W}, C {C} -> {O})", bitwise)
            del args


# the shapes at which the Hopper V1 runs right after every SM's shared
# memory was filled with bf16 NaN bits: offsets +-4 put corners outside the
# small image, Cin 24 and 21 end inside the last 16-channel step (21 inside
# a 4-channel group too), and 20 x 21 pixels leave a short last item
V1_POISONED = ((32, 20, 21, 24, 32), (32, 20, 21, 21, 32))


def _dead_corner_share(offset, mask):
    """The share of the corners of live taps (wv != 0) that lie outside the
    image, from K1's windowed fields."""
    H, W = offset.shape[1:3]
    y0, fy, x0, fx, wv = _sample_fields(offset.float(), mask.float(), True)[:5]
    live = (wv != 0).float()
    dead = sum(((inb == 0).float() * live).sum() for *_, inb, _, _ in
               _corners(y0, fy, x0, fx, H, W))
    return (dead / (4 * live.sum())).item()


def _check_own_wide():
    """Both V1 kernels at VARIANT_WIDE (C 64) in the 4 windowed cases
    (`_hold_own`)."""
    B, H, W, C, O = VARIANT_WIDE
    for dtype in (torch.float32, torch.bfloat16):
        for off_range in (1.5, 4.0):
            args = _deform_inputs(B, H, W, C, O, off_range, dtype)
            _hold_own(args, f"{_case_label(dtype, 'windowed', off_range, B)} "
                            f"({H}x{W}, C {C} -> {O})")
            del args


def _check_v1_poisoned():
    """For each of V1_POISONED, `csrc/smem_poison.cu` fills every SM's
    shared memory with 0xFFFF (a bf16 NaN) and the Hopper V1 launches right
    after it on the same stream: it must read no stage row of a dead corner
    and no channel past Cin (stale NaN bits there would reach its output),
    so its output must be finite and within V1's limits of its plain
    version, and the Hopper K1's output outside them."""
    from mgdt_yolo_tpu_torch.utils.build import load_library
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    poison = load_library("smem_poison",
                          (("smem_poison", i32, (i32, i64, i32, ptr, ptr)),)).smem_poison
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, H, W, C, O in V1_POISONED:
        args = _deform_inputs(B, H, W, C, O, 4.0, torch.bfloat16)
        hit = torch.zeros(1024, dtype=torch.int32, device=DEVICE)
        err = poison(0xFFFF, cuda_deform._MAX_SMEM, 4 * sms, hit.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"smem_poison failed: CUDA error {err}")
        got = cuda_deform_variants.deform_fwd_bf16_fma(*args)
        torch.cuda.synchronize()
        filled = int((hit > 0).sum())
        with float32_exact():
            want = deform_bf16_fma_plain(*args)
        c, control = compare(got, want), compare(cuda_deform.deform_fwd(*args), want)
        ok = filled >= sms and c["ok"] and not control["ok"]
        log(f"deform_fwd_bf16_fma after NaN bits in the shared memory of {filled} of {sms} SMs, "
            f"bf16 offsets +-4.0 ({B},{H},{W},{C}->{O}), "
            f"{_dead_corner_share(args[1], args[2]):.2%} of the live taps' corners outside the "
            f"image: finite {bool(torch.isfinite(got).all())}, max_abs_err "
            f"{c['max_abs_err']:.3e} (tol {c['tol']:.3e}), differing {c['mismatch_share']:.3%}; "
            f"the Hopper K1 differing {control['mismatch_share']:.3%} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the Hopper V1 read shared memory it did not write, or the poison "
                             "missed an SM")
        del args, got


def _check_variants(B, H, W, C, O):
    """The ten variant kernels at the main path's shape in 4 cases and at
    two ragged shapes (H, W not multiples of 8) in 4 each, with their plans;
    V2 and V3 also at the JAX tool's check shape; V4 and V5 where V4's skips
    fire, at C 64 and at the JAX tools' check shape; V1 at C 64 and after
    the shared memory was poisoned (`_check_v1_poisoned`); times
    each beside the SIMT K1 in the serving path's case (bf16, offsets
    +-1.5)."""
    bitwise = {}
    _check_hopper_plans(((B, H, W, C, O), (2, 20, 28, 32, 32), (2, 13, 21, 32, 32),
                         (TRAIN_BATCH, H, W, C, O), VARIANT_WIDE))
    # the last shape gives the slab kernels items of fewer than 16 pixels and
    # offsets and masks that are not 16-byte aligned (their 4-byte and plain
    # copies)
    for shape in ((B, H, W, C, O), (2, 20, 28, 32, 32), (2, 13, 21, 32, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            for off_range in (1.5, 4.0):
                errs = _check_variant_case(shape, dtype, off_range, bitwise)
                if shape[0] == B and dtype == torch.bfloat16 and off_range == 1.5:
                    main_errs = errs    # the serving path's case
    # V2 and V3, both designs, at the JAX tool's check shape (Cin 8 -> Cout 6,
    # with and without a bias), the Hopper ones bit for bit the Hopper K1
    proto_deform_qxhoist.check()
    # V4 and V5 where the skips fire and at C 64, then both designs at the
    # JAX tools' check shape (Cin 8 -> Cout 6), each bit for bit its K1
    _check_skip_and_walk(B, H, W, C, O, bitwise)
    proto_deform_slot_skip.check()
    proto_deform_tapwalk.check()
    _check_own_wide()
    _check_v1_poisoned()
    args = _deform_inputs(B, H, W, C, O, 1.5, torch.bfloat16)
    # the plain versions of V2-V5 are one function, K1's: timed once
    plain_ms = {plain: cuda_time_ms(lambda: plain(*args), iters=5)
                for plain in {p for _, p in ALL_VARIANTS.values()}}
    bound_ms, bound_by = deform_fwd_bound_ms(B, H, W, C, O, "bfloat16")
    entries = []
    for name, (fn, plain) in ALL_VARIANTS.items():
        row = deform_ab.ab(f"b{B} serving case", name, fn, plain, args, iters=20, windows=5,
                           plain_images=B)
        ref = "bitwise_to_hopper_k1" if name in BITWISE_TO_HOPPER_K1 else "bitwise_to_k1"
        held = {ref: bitwise[name]} if name in bitwise else {
            "reference": "its plain version, within compare's limits, with K1's output outside "
                         "them (and the Hopper V1 within them of its first design)"}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"mgdt_yolo_tpu_torch/csrc/{VARIANT_SOURCES[name]}.cu",
            "replaces": VARIANT_SITES[name],
            "shape": f"x ({B},{H},{W},{C}) bf16, weight (3,3,{C},{O}), windowed",
            "launches": None, "max_abs_err": main_errs[name], "max_err": main_errs[name],
            "ms": row["ms"], "plain_ms": plain_ms[plain], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "k1_ms": row["k1_ms"],
            **held, "max_rel_diff_from_k1": row["max_rel_diff"],
            **_usage(name)})
    return entries


def phase_kernels():
    """K1 (DCNv2 forward) and K2 (DCNv2 backward) against their plain
    versions at the main paths' shape, 80x80 map, C_in = C_out = 32, in the
    8 cases at b8 and b32, then each against its SIMT baseline in turns (the
    "DCN A/B" path, counted); K1 and K2 at C 64 and C 128 (their second
    plan); K3 (flip + HSV + normalise) and the SIMT K3 at the augmented
    training batch, bitwise over every RGB triple, and in turns (the "K3
    A/B" path, counted); the five K1 variants as K1. Returns the kernel
    entries and the DCN and K3 A/B paths' launches."""
    log("== phase 3: kernels against their plain versions")
    H, W, C, O = 80, 80, 32, 32
    errs = _check_dcn(H, W, C, O)
    reset_counts()
    rows = _dcn_ab(H, W, C, O)
    torch.cuda.synchronize()
    ab_launches = read_counts()
    log(f"launches during the DCN A/B path: {ab_launches}")
    _check_plans()
    wide = _check_dcn_wide()
    tta = _check_tta_maps()
    dcn = _dcn_entries(H, W, C, O, errs, rows)
    for e in dcn:
        if e["name"] in wide:
            e["wide"] = wide[e["name"]]
        if e["name"] == "deform_fwd":
            e["tta_maps"] = tta
    k3, k3_launches = _check_augment(TRAIN_BATCH, IMGSZ, IMGSZ)
    kernels = [*dcn, *k3, *_check_variants(8, H, W, C, O)]
    return kernels, ab_launches, k3_launches


def phase_serving():
    log("== phase 4: serving path (MGDT-n, fused, bf16, 640 px)")
    model = DetectionModel.from_npz(WEIGHTS, device=DEVICE).fuse().to(torch.bfloat16)
    log(f"deform semantics {model.deform_semantics}, fused {model.n_fused} Conv+BN pairs")
    requests = [synthetic_batch(b, IMGSZ) for b in (1, 8, 32)]
    reset_counts()
    results = [predict(model, imgs) for imgs in requests]
    torch.cuda.synchronize()
    launches = read_counts()
    for imgs, (det, counts) in zip(requests, results):
        b = imgs.shape[0]
        log(f"request b{b}: det {tuple(det.shape)}, detections per image "
            f"min {int(counts.min())} max {int(counts.max())}")
        if det.shape != (b, 300, 6) or not bool(torch.isfinite(det).all()):
            raise SystemExit("serving path gave malformed or non-finite detections")
    # at 640 px (twice the weights' training size) some scenes have none
    if sum(int(counts.sum()) for _, counts in results) == 0:
        raise SystemExit("serving path found no detections")
    log(f"launches during the serving path: {launches}")
    if launches != no_launches(deform_fwd=len(requests)):
        raise SystemExit("deform_fwd did not launch exactly once per forward (and no other "
                         "kernel)")
    return model, launches


def phase_throughput(model):
    log("== phase 5: serving throughput (bf16, fused, 640 px, input resident on the card)")
    rates = {}
    for b in (1, 32, 128):
        x = torch.from_numpy(synthetic_batch(b, IMGSZ)).to(DEVICE)
        ms = cuda_time_ms(lambda: predict(model, x), iters=10 if b < 128 else 3)
        rates[f"b{b}"] = b / (ms / 1e3)
        log(f"b{b}: {ms:.3f} ms per batch, {rates[f'b{b}']:.2f} images/s")
    log("throughput images/s: " + json.dumps(rates))


def _dcn(model):
    """The model's DyDCNv2 (None for a model without one)."""
    return next((m for m in model.modules() if isinstance(m, DyDCNv2)), None)


def _dcn_weight_grad(trainer, batch):
    """The DCN weight's gradient from one forward and backward of `batch`
    (no optimizer step); every gradient is cleared afterwards."""
    model = trainer.model
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=trainer.amp):
        feats = model.forward_feats(batch["img"].float() / 255.0)
    trainer.criterion(feats, batch, trainer.step).total.backward()
    grad = _dcn(model).weight.grad.detach().clone()
    for p in model.parameters():
        p.grad = None
    return grad


def phase_training():
    n_steps = 6
    log(f"== phase 6: training path (MGDT-n, unfused, train(), bf16 autocast, "
        f"b{TRAIN_BATCH}, {IMGSZ} px, {n_steps} micro-steps)")
    model = DetectionModel.from_npz(WEIGHTS, device=DEVICE)
    ds = SyntheticDetectionDataset(n=TRAIN_BATCH * n_steps, imgsz=IMGSZ, seed=0)
    loader = DataLoader(ds, TRAIN_BATCH, IMGSZ)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, loader, overrides=TRAIN_OVERRIDES, save_dir=tmp)
        log(f"optimizer {trainer.optimizer.name}, accumulate {trainer.accumulate}, "
            f"deform semantics {model.deform_semantics}, bf16 autocast {trainer.amp}, "
            f"max_gt {loader.max_gt}")
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        history = trainer.history
        launches = read_counts()
        wall = time.perf_counter() - t0
        meta = json.loads((Path(tmp) / "weights" / "last_metadata.json").read_text())
        back = DetectionModel.from_npz(Path(tmp) / "weights" / "last.npz", device=DEVICE)
    for i, m in enumerate(history):
        log(f"micro-step {i}: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    log(f"{n_steps} micro-steps (data made on the host included) in {wall:.2f} s; "
        f"optimizer updates {trainer.optimizer.count}, EMA updates {trainer.ema.updates}")
    log(f"launches during the training path: {launches}")
    if not all(math.isfinite(float(m["loss"])) for m in history):
        raise SystemExit("a training loss is not finite")
    if launches != no_launches(deform_fwd=n_steps, deform_bwd=n_steps):
        raise SystemExit("deform_fwd and deform_bwd did not launch once per micro-step "
                         "(and no other kernel) on unaugmented training")
    if trainer.optimizer.count != n_steps // trainer.accumulate:
        raise SystemExit("the optimizer did not step once per accumulation")
    log(f"checkpoint: deform_semantics {meta['deform_semantics']}, step {meta['step']}, "
        f"reloaded pinned {back.deform_semantics}")
    if meta["deform_semantics"] != "windowed" or back.deform_semantics != "windowed":
        raise SystemExit("the checkpoint lost the deform semantics pin")
    batch = to_device(collate([ds[i] for i in range(TRAIN_BATCH)], IMGSZ, loader.max_gt),
                      DEVICE)
    grad = _dcn_weight_grad(trainer, batch)
    gnorm = grad.float().norm().item()
    log(f"DCN weight gradient: norm {gnorm:.4e}, max |g| {grad.abs().max().item():.4e}")
    if not (math.isfinite(gnorm) and gnorm > 0):
        raise SystemExit("the DCN weight got no finite, non-zero gradient")
    return trainer, batch, launches


def phase_fixed_batch(trainer, batch):
    log(f"== phase 7: training on one fixed batch (b{TRAIN_BATCH}, bf16 autocast)")
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(16)]
    log("losses: " + ", ".join(f"{v:.4f}" for v in losses))
    first, last = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    log(f"mean loss of the first 4 micro-steps {first:.4f}, of the last 4 {last:.4f}")
    if not (all(math.isfinite(v) for v in losses) and last < first):
        raise SystemExit("the loss did not fall on a fixed batch")
    ms = cuda_time_ms(lambda: trainer.train_step(batch), iters=4, windows=3)
    log(f"train b{TRAIN_BATCH}: {ms:.3f} ms per micro-step "
        f"(an optimizer update every {trainer.accumulate}), "
        f"{TRAIN_BATCH / ms * 1e3:.2f} train images/s")


def phase_card_vs_cpu():
    log("== phase 8: serving in float32 on the card against float32 on the CPU")
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


def grad_names(model):
    """The gradients compared in phases 9 and 13: the DCN weight, the two
    tensors that take K2's other gradients first (the offset/mask conv: d
    offset and d mask; the regression branch's reduction: d x), and backbone
    kernels from the stem to the deepest stage."""
    head = f"model_{model.specs[-1].i}"
    return (f"{head}.DyDCNV2.weight", f"{head}.spatial_conv_offset.weight",
            f"{head}.reg_decomp.reduction_weight", "model_0.conv.weight",
            "model_1.conv.weight", "model_3.conv.weight", "model_7.conv.weight",
            "model_9.cv2.conv.weight")


# float32, TF32 off: ~60 layers of convolutions and norms reordered by cuDNN
# and the CPU, and the DCN backward's atomics. Loss parts to 1e-4 of their
# value; each gradient to 5e-3 of its tensor's largest value: the backward
# through the backbone compounds cuDNN's float32 rounding (a sound step
# reaches 1.5e-3 at model_7). Phase 9 also plants faults in K2's output and
# fails unless each one breaks this limit somewhere.
PARTS_TOL, GRAD_TOL = 1e-4, 5e-3


def _planted(fault):
    """K2's four gradients with one term of `fault` dropped."""
    def wrong(dx, doff, dmask, dw):
        if fault == "dx":
            dx = torch.zeros_like(dx)
        elif fault == "d_offset x":      # offsets are (y, x) per tap
            doff = doff.clone()
            doff[..., 1::2] = 0
        elif fault == "d_offset tap 0":
            doff = doff.clone()
            doff[..., 0:2] = 0
        elif fault == "d_mask":
            dmask = torch.zeros_like(dmask)
        return dx, doff, dmask, dw
    return wrong


def _float32_train_step(dev, batch, fault=None, name=None):
    """Loss parts and the `grad_names` gradients of one float32 training
    forward and backward on `dev`: of the flagship from its weights, or of
    the config `name` (nc=2) from the port's seeded init; `fault` plants
    `_planted(fault)` into the DCN's backward."""
    model = (DetectionModel.from_npz(WEIGHTS, device=dev) if name is None else
             DetectionModel(name, nc=ABLATION_NC, device=dev)).train()
    crit = Trainer(model, overrides={**TRAIN_OVERRIDES, "amp": False},
                   steps_per_epoch=1).criterion
    b = to_device(batch, dev)
    real = cuda_deform.deform_bwd
    if fault:
        cuda_deform.deform_bwd = lambda *a: _planted(fault)(*real(*a))
    try:
        with float32_exact():
            out = crit(model.forward_feats(b["img"].float() / 255.0), b, 0)
            out.total.backward()
    finally:
        cuda_deform.deform_bwd = real
    params = dict(model.named_parameters())
    return out.parts.cpu(), {n: params[n].grad.cpu() for n in grad_names(model)}


def _grad_gaps(got, want):
    """Each gradient's largest difference over its tensor's largest value."""
    return {n: (got[n] - want[n]).abs().max().item() / want[n].abs().max().item()
            for n in want}


def phase_train_card_vs_cpu():
    log("== phase 9: one float32 training step on the card against the CPU")
    ok, sound = True, {}
    for seed in (0, 1):
        ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=seed)
        batch = collate([ds[0], ds[1]], IMGSZ, 24)
        (pg, gg), (pc, gc) = (_float32_train_step(dev, batch) for dev in (DEVICE, "cpu"))
        log(f"seed {seed}: loss parts card {pg.tolist()} cpu {pc.tolist()}")
        ok &= bool(((pg - pc).abs() <= PARTS_TOL * pc.abs()).all())
        for n, gap in _grad_gaps(gg, gc).items():
            good = gap <= GRAD_TOL and gc[n].abs().max().item() > 0
            ok &= good
            sound[n] = max(sound.get(n, 0.0), gap)
            log(f"seed {seed}: gradient of {n}: max |diff| / max |g| {gap:.3e} "
                f"(max |g| {gc[n].abs().max().item():.3e}) {'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("the card's training step disagrees with the CPU's")
    worst = max(sound, key=sound.get)
    log(f"largest sound gap {sound[worst]:.3e} ({worst}), limit {GRAD_TOL:.0e}")
    # the limit's other reading: K2's output with one term dropped, card
    # against the sound CPU step of the last seed
    for fault in ("dx", "d_offset x", "d_offset tap 0", "d_mask"):
        _, gf = _float32_train_step(DEVICE, batch, fault)
        gaps = _grad_gaps(gf, gc)
        caught = {n: g for n, g in gaps.items() if g > GRAD_TOL}
        log(f"planted fault, {fault} dropped: caught by {len(caught)} of {len(gaps)} "
            "gradients; gaps " + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()))
        if not caught:
            raise SystemExit(f"phase 9's limit does not catch K2 with {fault} dropped")


def _box_stats(out):
    """(survivors per batch, smallest and largest surviving coordinate) of
    one augmented batch."""
    boxes = out["gt_bboxes"][out["mask_gt"]]
    n = int(out["mask_gt"].sum())
    return n, (boxes.min().item() if n else 0.0), (boxes.max().item() if n else 0.0)


def phase_augmented_training():
    log(f"== phase 10: augmented training path (MGDT-n, device augment with K3, "
        f"validation every epoch, bf16 autocast, b{TRAIN_BATCH}, {IMGSZ} px, "
        f"{AUG_EPOCHS} epochs of {AUG_STEPS} micro-steps, close_mosaic 1)")
    model = DetectionModel.from_npz(WEIGHTS, device=DEVICE)
    ds = SyntheticDetectionDataset(n=TRAIN_BATCH * AUG_STEPS, imgsz=IMGSZ, seed=0)
    loader = DataLoader(ds, TRAIN_BATCH, IMGSZ, device_augment=True)
    seen = []       # per micro-step: (step, mosaic share, survivors, min, max)

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, loader, overrides=AUG_OVERRIDES, save_dir=tmp)
        a = trainer.args
        log(f"device_augment {a['device_augment']}, mosaic {a['mosaic']}, scale {a['scale']}, "
            f"translate {a['translate']}, hsv {a['hsv_h']}/{a['hsv_s']}/{a['hsv_v']}, "
            f"fliplr {a['fliplr']}, val {a['val']}, max_gt {loader.max_gt}, "
            f"mosaic off from micro-step {trainer.mosaic_off_step}")

        def recording_augment(batch, step):
            out = trainer.augment(batch, step)
            seen.append((step, trainer.draws["use_mosaic"].float().mean().item(),
                         *_box_stats(out)))
            return out
        trainer.augment_fn = recording_augment
        reset_counts()
        t0 = time.perf_counter()
        results = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        rows = (Path(tmp) / "results.csv").read_text().splitlines()
        metas = {n: json.loads((Path(tmp) / "weights" / f"{n}_metadata.json").read_text())
                 for n in ("last", "best")}
        pins = {n: DetectionModel.from_npz(Path(tmp) / "weights" / f"{n}.npz",
                                           device=DEVICE).deform_semantics for n in metas}
    n_val = AUG_EPOCHS * len(trainer.val_loader)
    n_steps = AUG_EPOCHS * AUG_STEPS
    for i, m in enumerate(trainer.history):
        log(f"micro-step {i}: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    for step, mosaic, n, lo, hi in seen:
        log(f"augmented micro-step {step}: mosaic share {mosaic:.2f}, {n} boxes survive, "
            f"coordinates in [{lo:.3f}, {hi:.3f}]")
    log("results.csv:\n  " + "\n  ".join(rows))
    log("validation: " + ", ".join(f"{k} {v:.6f}" for k, v in results.items()))
    log(f"{n_steps} micro-steps and {AUG_EPOCHS} validations ({n_val} forwards) in "
        f"{wall:.2f} s; launches {launches}")
    log(f"checkpoints: last epoch {metas['last']['epoch']}, best_fitness "
        f"{metas['best']['best_fitness']:.6f}, pins {pins}")
    want = no_launches(deform_fwd=n_steps + n_val, deform_bwd=n_steps, fused_augment=n_steps)
    if launches != want:
        raise SystemExit(f"the augmented path launched {launches}, not {want}")
    if [s[1] for s in seen] != [1.0] * AUG_STEPS + [0.0] * (n_steps - AUG_STEPS):
        raise SystemExit("mosaic was not on in epoch 1 and off in epoch 2")
    if not all(n > 0 and lo >= 0 and hi <= IMGSZ for _, _, n, lo, hi in seen):
        raise SystemExit("an augmented batch has no box, or a box outside the image")
    if not all(math.isfinite(float(m["loss"])) for m in trainer.history):
        raise SystemExit("an augmented training loss is not finite")
    cells = [r.split(",") for r in rows[1:]]
    if rows[0] != "epoch,box_loss,cls_loss,dfl_loss,precision,recall,map50,map,fitness" or \
            len(cells) != AUG_EPOCHS or \
            not all(math.isfinite(float(v)) for r in cells for v in r):
        raise SystemExit("results.csv does not hold one finite row per epoch")
    if set(pins.values()) != {"windowed"} or \
            {m["deform_semantics"] for m in metas.values()} != {"windowed"}:
        raise SystemExit("a checkpoint lost the deform semantics pin")

    # times: the augmented against the unaugmented micro-step on the same
    # trainer, in turns; mosaic kept on so the augmented step is epoch 1's
    trainer.mosaic_off_step = None
    raw = to_device(next(iter(loader)), DEVICE)
    plain = to_device(collate([ds[i] for i in range(TRAIN_BATCH)], IMGSZ, loader.max_gt),
                      DEVICE)
    times = {"augmented": [], "unaugmented": []}
    for _ in range(2):
        for name, fn, batch in (("augmented", trainer.augment, raw),
                                ("unaugmented", None, plain)):
            trainer.augment_fn = fn
            times[name].append(cuda_time_ms(lambda: trainer.train_step(batch), iters=4,
                                            windows=3))
    step_ms = {k: min(v) for k, v in times.items()}
    draws = augment_draws(TRAIN_BATCH, IMGSZ, torch.Generator().manual_seed(0))
    aug_ms = cuda_time_ms(lambda: apply_augment(raw, draws, IMGSZ, loader.max_gt), iters=5,
                          windows=3)
    val_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.validate()
        torch.cuda.synchronize()
        val_s.append(time.perf_counter() - t0)
    for k in ("augmented", "unaugmented"):
        log(f"train b{TRAIN_BATCH} {k}: " + " / ".join(f"{t:.3f}" for t in times[k]) +
            f" ms per micro-step, best {step_ms[k]:.3f} ms, "
            f"{TRAIN_BATCH / step_ms[k] * 1e3:.2f} train images/s")
    log(f"apply_augment b{TRAIN_BATCH}: {aug_ms:.3f} ms "
        f"({aug_ms / step_ms['augmented']:.1%} of the augmented micro-step)")
    log(f"validation pass ({len(trainer.val_loader.dataset)} images, "
        f"{len(trainer.val_loader)} batch): " + " / ".join(f"{t:.3f}" for t in val_s) + " s")
    return launches, aug_ms, step_ms


def phase_augment_card_vs_cpu():
    log("== phase 11: apply_augment on the card against the CPU, the same draws")
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=3)
    raw = collate_raw([ds[0], ds[1]], IMGSZ, 24)
    # the warp's bf16 products are reduced in float32 on both sides: no
    # split reduction rounded to bf16 on the card
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        for hsv in (False, True):
            h = (0.015, 0.7, 0.4) if hsv else (0.0, 0.0, 0.0)
            draws = augment_draws(2, IMGSZ, torch.Generator().manual_seed(5), mosaic_p=1.0,
                                  fliplr=0.5, hsv_h=h[0], hsv_s=h[1], hsv_v=h[2])
            got = {k: v.cpu() for k, v in
                   apply_augment(to_device(raw, DEVICE), draws, IMGSZ, 24).items()}
            want = apply_augment(to_device(raw, "cpu"), draws, IMGSZ, 24)
            diff = (got["img"] - want["img"]).abs()
            share = (diff > 1e-6).float().mean().item()
            box_err = (got["gt_bboxes"] - want["gt_bboxes"]).abs().max().item()
            same = torch.equal(got["mask_gt"], want["mask_gt"]) and \
                torch.equal(got["gt_labels"], want["gt_labels"])
            # as tests/test_torch_augment.py holds the port to JAX: a bf16
            # product or sum rounded the other way moves a uint8 pixel by one
            # level per rounding (2/255 in all), and HSV's value gain (<= 1.4)
            # and the hue it carries can widen that to 4/255; boxes are float32
            # affine maps of pixel coordinates
            tol = (4 if hsv else 2) / 255 + 1e-6
            ok = same and box_err <= 1e-4 and diff.max().item() <= tol and share < 0.01 and \
                int(want["mask_gt"].sum()) > 0
            log(f"HSV {'on' if hsv else 'off'}: labels equal {same} "
                f"({int(want['mask_gt'].sum())} boxes), box max |diff| {box_err:.3e}, pixel "
                f"max |diff| {diff.max().item() * 255:.3f}/255 (tol {tol * 255:.0f}/255), "
                f"values more than 1e-6 apart {share:.4%} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("apply_augment on the card disagrees with the CPU")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


# phase 13: the seven other models of the ablation matrix, n-scale, full
# width and depth, nc=2, from the port's seeded init (no trained weights)
ABLATION = tuple(n for n in CONFIGS if n != FLAGSHIP)
ABLATION_NC = 2
ABLATION_SERVE, ABLATION_RATE, ABLATION_TRAIN, ABLATION_STEPS = 8, 32, 16, 2
# batch 16 with nbs 32: accumulate 2, so the two micro-steps make one update
ABLATION_OVERRIDES = {**TRAIN_OVERRIDES, "batch": ABLATION_TRAIN, "nbs": 32}
# float32 card against CPU, TF32 off: raw maps to 1e-3 of their magnitude
# (at least 1), as rounding of reordered sums (phase 8's flagship: < 1e-2
# absolute on maps of magnitude ~10)
ABLATION_RAW_TOL = 1e-3


def _dcn_shape(model):
    """"(h, w, C -> C)" of the model's DCN map at IMGSZ, or None."""
    dcn = _dcn(model)
    if dcn is None:
        return None
    s = model.stride[0]
    return f"({IMGSZ // s}, {IMGSZ // s}, {dcn.weight.shape[2]} -> {dcn.weight.shape[3]})"


def _profiled_ms(fn, calls):
    """K1's and K2's device ms per launch over `calls` calls of `fn`, from
    torch.profiler (the kernels' own device time, not the host's gaps)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, sym in (("deform_fwd", "deform_fwd_mma_kernel"),
                      ("deform_bwd", "deform_bwd_mma_kernel")):
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and sym in e.key]
        n = sum(e.count for e in hits)
        if n:
            out[name] = sum(device_us(e) for e in hits) / n / 1e3
    return out


def _calibrated_state(name):
    """`name`'s seeded init with every BatchNorm's statistics set to those
    of one batch of synthetic scenes (one train-mode forward at momentum 1).
    At the plain seeded init the deep features are so small that every
    anchor of a level scores its class prior to float32 rounding, so NMS
    would order ties by rounding."""
    model = DetectionModel(name, nc=ABLATION_NC, device=DEVICE).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad(), float32_exact():
        model(torch.from_numpy(synthetic_batch(8, IMGSZ)).to(DEVICE).float() / 255.0)
    return {k: v.cpu() for k, v in model.state_dict().items()}


def _ablation_card_vs_cpu(name):
    """A float32 fused forward of two noise images on the card and on the
    CPU (plain DCN), from `_calibrated_state`: raw maps within
    ABLATION_RAW_TOL, decoded boxes within 0.5 px and scores within 1e-3;
    then NMS on the card and on the CPU given the same decoded tensor (the
    CPU's), at the serving settings but a threshold that passes ~1000
    anchors: the same counts, boxes and scores within 1e-4. With no trained
    weights many anchors score within rounding of each other, so NMS on each
    device's own output may keep the other of two near-equal boxes: that
    end-to-end comparison is logged, not held. Noise images, since a
    synthetic scene's flat background gives many anchors one score."""
    x = torch.rand((2, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(13))
    state, outs = _calibrated_state(name), []
    for dev in (DEVICE, "cpu"):
        model = DetectionModel(name, nc=ABLATION_NC, device=dev)
        model.load_state_dict(state)
        model.fuse()
        with torch.no_grad(), float32_exact():
            decoded, feats = model(x.to(dev))
        outs.append(([f.cpu() for f in feats], decoded.cpu()))
    (fg, dg), (fc, dc) = outs
    raw_err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                  for a, b in zip(fg, fc))
    box_err = (dg[:, :4] - dc[:, :4]).abs().max().item()
    score_err = (dg[:, 4:] - dc[:, 4:]).abs().max().item()
    ranked = dc[:, 4:].amax(1).flatten().sort(descending=True).values
    thr = float(ranked[min(999, len(ranked) - 1)])
    kw = dict(conf_thres=thr, iou_thres=predictor.IOU, max_det=predictor.MAX_DET,
              pre_topk=predictor.PRE_TOPK, block=predictor.BLOCK)
    (det_g, cnt_g), (det_c, cnt_c) = ((t.cpu() for t in non_max_suppression(dc.to(dev), **kw))
                                      for dev in (DEVICE, "cpu"))
    same = torch.equal(cnt_g, cnt_c) and int(cnt_c.sum()) > 0
    nms_err = (det_g - det_c).abs().max().item() if same else None
    own_g = non_max_suppression(dg.to(DEVICE), **kw)[1].cpu()
    ok = raw_err <= ABLATION_RAW_TOL and box_err < 0.5 and score_err <= 1e-3 and same and \
        nms_err <= 1e-4
    log(f"{name} float32 card vs CPU: raw maps max |diff| / max(1, max |raw|) {raw_err:.3e} "
        f"(limit {ABLATION_RAW_TOL:.0e}), decoded boxes max |diff| {box_err:.3e} px, scores "
        f"{score_err:.3e}; NMS at conf {thr:.6f} on the same decoded tensor: kept card "
        f"{cnt_g.tolist()} cpu {cnt_c.tolist()}, max |diff| {nms_err}; on each device's own "
        f"output: card {own_g.tolist()} (logged) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the card and the CPU disagree")
    return raw_err


def _ablation_serving(name, k1_want):
    """Fused bf16 `predict` at ABLATION_SERVE (counted), images/s at
    ABLATION_RATE, and K1's time per launch inside the forward."""
    model = DetectionModel(name, nc=ABLATION_NC, device=DEVICE).fuse().to(torch.bfloat16)
    imgs = synthetic_batch(ABLATION_SERVE, IMGSZ)
    reset_counts()
    det, counts = predict(model, imgs)
    torch.cuda.synchronize()
    launches = read_counts()
    if det.shape != (ABLATION_SERVE, 300, 6) or not bool(torch.isfinite(det).all()):
        raise SystemExit(f"{name}: serving gave malformed or non-finite detections")
    if launches != no_launches(deform_fwd=k1_want):
        raise SystemExit(f"{name}: serving launched {launches}, K1 {k1_want} times expected")
    x = torch.from_numpy(synthetic_batch(ABLATION_RATE, IMGSZ)).to(DEVICE)
    ms = cuda_time_ms(lambda: predict(model, x), iters=5, windows=3)
    xs = torch.from_numpy(imgs).to(DEVICE)
    kernel_ms = _profiled_ms(lambda: predict(model, xs), 5) if k1_want else {}
    return launches, {"fused": model.n_fused, "detections_b8": int(counts.sum()),
                      "rate_ms": ms, "images_per_s": ABLATION_RATE / ms * 1e3,
                      "k1_ms_b8": kernel_ms.get("deform_fwd")}


def _ablation_training(name, k_want):
    """`Trainer.train()` over ABLATION_STEPS unaugmented micro-steps at
    ABLATION_TRAIN (counted), its checkpoint reloaded, the DCN weight's
    gradient, the micro-step's time and K1's and K2's times inside it."""
    model = DetectionModel(name, nc=ABLATION_NC, device=DEVICE)
    ds = SyntheticDetectionDataset(n=ABLATION_TRAIN * ABLATION_STEPS, imgsz=IMGSZ, seed=0)
    loader = DataLoader(ds, ABLATION_TRAIN, IMGSZ)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, loader, overrides=ABLATION_OVERRIDES, save_dir=tmp)
        reset_counts()
        trainer.train()
        torch.cuda.synchronize()
        launches = read_counts()
        meta = json.loads((Path(tmp) / "weights" / "last_metadata.json").read_text())
        back = DetectionModel.from_npz(Path(tmp) / "weights" / "last.npz", device=DEVICE)
    losses, updates = [float(m["loss"]) for m in trainer.history], trainer.optimizer.count
    if not (len(losses) == ABLATION_STEPS and all(math.isfinite(v) for v in losses)):
        raise SystemExit(f"{name}: a training loss is not finite")
    if launches != no_launches(deform_fwd=k_want, deform_bwd=k_want):
        raise SystemExit(f"{name}: training launched {launches}, K1 and K2 {k_want} times "
                         "expected")
    if updates != ABLATION_STEPS // trainer.accumulate:
        raise SystemExit(f"{name}: the optimizer did not step once per accumulation")
    ema = trainer.ema.state()
    same = (back.model_yaml, back.nc, back.stride, back.reg_max) == \
        (name, ABLATION_NC, model.stride, model.reg_max) and meta["model_yaml"] == name and \
        all(torch.equal(p, ema[n]) for n, p in back.named_parameters())
    if not same:
        raise SystemExit(f"{name}: last.npz did not reload as the same config and weights")
    del back
    batch = to_device(collate([ds[i] for i in range(ABLATION_TRAIN)], IMGSZ, loader.max_gt),
                      DEVICE)
    gnorm = None
    if k_want:
        grad = _dcn_weight_grad(trainer, batch)
        gnorm = grad.float().norm().item()
        if not (math.isfinite(gnorm) and gnorm > 0):
            raise SystemExit(f"{name}: the DCN weight got no finite, non-zero gradient")
    ms = cuda_time_ms(lambda: trainer.train_step(batch), iters=4, windows=3)
    kernel_ms = _profiled_ms(lambda: trainer.train_step(batch), 4) if k_want else {}
    return launches, {"losses": losses, "updates": updates,
                      "dcn_grad_norm": gnorm, "step_ms": ms,
                      "train_images_per_s": ABLATION_TRAIN / ms * 1e3,
                      "k1_ms_train": kernel_ms.get("deform_fwd"),
                      "k2_ms_train": kernel_ms.get("deform_bwd")}


def _ablation_train_card_vs_cpu(name):
    """One float32 training step of `name` on the card and on the CPU (two
    scenes): loss parts to 1e-4 and gradients to GRAD_TOL, as phase 9; on
    the thead models' C 64 map K1 and K2 run their streamed plan there."""
    ds = SyntheticDetectionDataset(n=2, imgsz=IMGSZ, seed=0)
    batch = collate([ds[0], ds[1]], IMGSZ, 24)
    reset_counts()
    (pg, gg), (pc, gc) = (_float32_train_step(dev, batch, name=name) for dev in (DEVICE, "cpu"))
    launches = read_counts()
    ok = bool(((pg - pc).abs() <= PARTS_TOL * pc.abs()).all()) and \
        launches == no_launches(deform_fwd=1, deform_bwd=1)
    gaps = _grad_gaps(gg, gc)
    ok &= all(g <= GRAD_TOL and gc[n].abs().max().item() > 0 for n, g in gaps.items())
    log(f"{name} float32 training step, card vs CPU: parts card {pg.tolist()} cpu "
        f"{pc.tolist()}; gradient gaps " + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()) +
        f"; launches K1 {launches['deform_fwd']} K2 {launches['deform_bwd']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the card's float32 training step disagrees with the CPU's")
    return max(gaps.values())


def phase_ablation(wide):
    log(f"== phase 13: the ablation family: the seven other models of the paper's ablation "
        f"matrix (n-scale, nc={ABLATION_NC}, the port's seeded init, {IMGSZ} px): fused bf16 "
        f"serving at b{ABLATION_SERVE} and images/s at b{ABLATION_RATE}, float32 card vs CPU, "
        f"unaugmented training at b{ABLATION_TRAIN} ({ABLATION_STEPS} micro-steps), "
        f"the checkpoint reloaded")
    totals, rows = dict.fromkeys(COUNTERS, 0), {}
    for name in ABLATION:
        t0 = time.perf_counter()
        probe = DetectionModel(name, nc=ABLATION_NC, device="cpu")
        shape, k = _dcn_shape(probe), int(_dcn(probe) is not None)
        row = {"stride": list(probe.stride), "reg_max": probe.reg_max, "dcn": shape}
        del probe
        served, serve = _ablation_serving(name, k)
        trained, train = _ablation_training(name, k * ABLATION_STEPS)
        for key in totals:
            totals[key] += served[key] + trained[key]
        row.update(serve, **train, launches={"deform_fwd": served["deform_fwd"] +
                                             trained["deform_fwd"],
                                             "deform_bwd": trained["deform_bwd"]})
        row["raw_err"] = _ablation_card_vs_cpu(name)
        if shape and shape.endswith("64 -> 64)"):
            plans = {f"{kern} {t}": cuda_deform.plan(kern, Cin=64, Cout=64, W=IMGSZ // 16,
                                                      bf16=int(t == "bf16"))
                     for kern in ("deform_fwd", "deform_bwd") for t in ("bf16", "float32")}
            log(f"{name}: plans at C 64 on the {IMGSZ // 16}-wide map: {plans}")
            if plans["deform_bwd float32"] != "streamed":
                raise SystemExit("K2 does not take its streamed plan at C 64 in float32")
            row["plans"] = plans
            row["train_grad_gap"] = _ablation_train_card_vs_cpu(name)
        rows[name] = row
        torch.cuda.empty_cache()
        log(f"{name}: strides {row['stride']}, reg_max {row['reg_max']}, DCN {shape}; "
            f"{row['fused']} Conv+BN pairs fused; b{ABLATION_RATE} {row['rate_ms']:.3f} ms, "
            f"{row['images_per_s']:.2f} images/s; train b{ABLATION_TRAIN} "
            f"{row['step_ms']:.3f} ms per micro-step ({row['train_images_per_s']:.2f} train "
            f"images/s), losses {', '.join(f'{v:.4f}' for v in row['losses'])}, "
            f"{row['updates']} update(s); DCN weight gradient norm {row['dcn_grad_norm']}; "
            f"K1 {row['k1_ms_b8']} ms per launch serving b{ABLATION_SERVE}, K1 "
            f"{row['k1_ms_train']} and K2 {row['k2_ms_train']} ms per launch training "
            f"b{ABLATION_TRAIN}; launches {row['launches']}; {time.perf_counter() - t0:.1f} s")
    c64 = {kern: wide[kern]["C64"]["bfloat16"]["ms"] for kern in ("deform_fwd", "deform_bwd")}
    log(f"phase 3's synthetic C 64 (8, 40, 40) bf16: K1 {c64['deform_fwd']:.4f} ms, K2 "
        f"{c64['deform_bwd']:.4f} ms")
    log(f"launches during the ablation family's counted runs: {totals}")
    return totals, rows


AB_TOOLS = (proto_deform_bf16_fma, proto_deform_qxhoist, proto_deform_slot_skip,
            proto_deform_tapwalk)


def _ab_sound(row):
    """An A/B row's output against the SIMT K1's: the first designs of V4 and
    V5 give its bits; the Hopper V2-V5 and the first designs of V2 and V3
    (K1's function) stay within two bf16 roundings of its largest output,
    both V1 kernels (bf16 weights and products) within four."""
    if row["variant"] in BITWISE_TO_K1:
        return row["max_abs_diff"] == 0.0
    own = ALL_VARIANTS[row["variant"]][1] is not windowed_plain
    limit = (4 if own else 2) * 2 ** -8
    return math.isfinite(row["max_rel_diff"]) and row["max_rel_diff"] <= limit


def phase_variant_ab():
    log(f"== phase 12: K1 variant A/B: the four ported A/B tools at their own shapes, then "
        f"the ten variant kernels at b{TRAIN_BATCH} (bf16, windowed, offsets +-1.5) "
        f"against the SIMT K1, then the Hopper V1-V5 against their first designs and the "
        f"Hopper K1")
    reset_counts()
    rows, hopper_rows, plan_rows, baseline = [], [], [], 0
    for tool in AB_TOOLS:
        result = tool.bench()
        rows += result["cases"]
        hopper_rows += result.get("hopper", []) + result.get("skips_firing", [])
        plan_rows += result.get("plans", [])
        baseline += result.get("hopper_k1_launches", 0)
        torch.cuda.empty_cache()
    args = _deform_inputs(TRAIN_BATCH, 80, 80, 32, 32, 1.5, torch.bfloat16)
    rows += [deform_ab.ab(f"b{TRAIN_BATCH} main path", name, fn, plain, args, iters=10,
                          plain_images=TRAIN_BATCH)
             for name, (fn, plain) in ALL_VARIANTS.items()]
    main_rows = [deform_ab.ab_hopper(f"b{TRAIN_BATCH} main path", name, args, iters=10,
                                     plain_images=TRAIN_BATCH) for name in FIRST_DESIGNS]
    hopper_rows += main_rows
    torch.cuda.synchronize()
    launches = read_counts()
    del args
    torch.cuda.empty_cache()
    log(f"launches during the A/B path: {launches}")
    # the SIMT K1 is the baseline of every variant; the Hopper K1 launches
    # only as the Hopper variants' baseline (each tool's bench and ab_hopper
    # count their runs of it); K2 never
    baseline += sum(r["hopper_k1_launches"] for r in main_rows)
    if launches["deform_fwd_simt"] == 0 or launches["deform_fwd"] != baseline or \
            any(launches[k] for k in ("deform_bwd", "deform_bwd_simt")):
        raise SystemExit(f"the variants' A/B ran other kernels than its baselines: the Hopper "
                         f"K1 {launches['deform_fwd']} times, {baseline} of them as the Hopper "
                         f"variants' baseline")
    log("case | variant | shape | K1 ms | variant ms | K1 / variant | max |d| | max rel |d| "
        "from K1 | images held | max |d| | differing from the plain version")
    for r in rows:
        log(f"  {r['case']} | {r['variant']} | {r['shape']} | {r['k1_ms']:.4f} | "
            f"{r['ms']:.4f} | {r['ratio']:.3f} | {r['max_abs_diff']:.3e} | "
            f"{r['max_rel_diff']:.3e} | {r['plain_images']} | {r['max_abs_err']:.3e} | "
            f"{r['mismatch_share']:.3%}")
    log("case | Hopper variant | ms | its SIMT design ms | SIMT / Hopper | Hopper K1 ms | "
        "K1 / variant | share of the bound | reference held")
    for r in hopper_rows:
        held = "the Hopper K1's bits" if r["bitwise_to_hopper_k1"] else (
            f"its first design, differing {r['first_design_mismatch_share']:.3%}")
        log(f"  {r['case']} | {r['variant']} | {r['ms']:.4f} | {r['simt_ms']:.4f} | "
            f"{r['simt_over_hopper']:.3f} | {r['hopper_k1_ms']:.4f} | "
            f"{r['k1_over_variant']:.3f} | {r['share_of_bound']:.2%} | {held}")
    log("the Hopper V5's plans at b512 C 64 (small-off), in turns: warps | items per warp | "
        "bytes | ms | the Hopper K1 ms | K1 / V5")
    for r in plan_rows:
        log(f"  {r['warps']} | {r['items_per_warp']} | {r['smem']} | {r['ms']:.4f} | "
            f"{r['hopper_k1_ms']:.4f} | {r['k1_over_variant']:.3f}"
            f"{' (chosen)' if r['chosen'] else ''}")
    bad = [f"{r['variant']} ({r['case']})" for r in rows if not _ab_sound(r)]
    if bad:
        raise SystemExit("an A/B variant strays from K1: " + ", ".join(bad))
    return launches, rows, hopper_rows, plan_rows


# phase 14: the serving entry points. Scenes of a camera frame, an HD frame,
# a VGA image and a photo; the server under one closed-loop client and 16
SCENE_SIZES = ((480, 640), (720, 1280), (1080, 1920), (375, 500))
N_SCENES = 64
ENTRY_BATCHES = (1, 32)
SERVE_BATCH, SERVE_WAIT_MS, SERVE_REQUESTS, SERVE_CLIENTS = 8, 2.0, 256, (1, 16)
# the float32 card-vs-CPU holds: the first scenes (each size 4 times; TTA 2)
HOLD_SCENES, HOLD_TTA_SCENES, HOLD_BOX_PX = 16, 8, 0.5


def _scenes(n):
    """`n` seeded BGR scenes, the sizes in turn: synthetic scene i (the
    committed weights' kind of scene) made at the larger side, cut to size."""
    out = []
    for i in range(n):
        h, w = SCENE_SIZES[i % len(SCENE_SIZES)]
        out.append(np.ascontiguousarray(synthetic_scene(i, max(h, w), seed=7)[:h, :w]))
    return out


def _entry_predictor(model, device, **kw):
    return DetectionPredictor(overrides={"imgsz": IMGSZ, "device": device, **kw}
                              ).setup_model(model)


def _hold_results(got, want, name):
    """Per image: the same number of detections and classes, boxes in the
    original image's pixels within HOLD_BOX_PX. Returns the largest box and
    score differences; ends the script on a disagreement."""
    box = score = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        a, b = g.boxes.data, w.boxes.data
        if a.shape != b.shape or not (a[:, 5] == b[:, 5]).all():
            raise SystemExit(f"{name}: scene {i} has {len(a)} detections on the card and "
                             f"{len(b)} on the CPU, or other classes")
        if len(a):
            box = max(box, float(np.abs(a[:, :4] - b[:, :4]).max()))
            score = max(score, float(np.abs(a[:, 4] - b[:, 4]).max()))
    n = sum(len(g) for g in got)
    log(f"{name}: {n} detections over {len(got)} scenes, counts equal, box max |diff| "
        f"{box:.3e} px (limit {HOLD_BOX_PX}), score max |diff| {score:.3e}")
    if box > HOLD_BOX_PX or n == 0:
        raise SystemExit(f"{name}: the card and the CPU disagree")
    return box


def _timed_predict(p, scenes, batch, name, forwards_per_batch=1, n=None):
    """One counted, timed run of the predictor (after one warm-up run) over
    `scenes` (images, or a source of `n` files): images/s over the wall
    time, the per-image preprocess and inference ms, and K1 launched once
    per forward (`forwards_per_batch` a batch) and no other kernel. Returns
    (results, launches, row)."""
    p(scenes, batch=batch)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = p(scenes, batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n = len(scenes) if n is None else n
    pre = sum(r.speed["preprocess"] for r in results) / n
    inf = sum(r.speed["inference"] for r in results) / n
    row = {"images_per_s": n / wall, "wall_s": wall, "preprocess_ms": pre, "inference_ms": inf,
           "preprocess_share": pre / (pre + inf), "detections": sum(len(r) for r in results)}
    log(f"{name}: {row['images_per_s']:.2f} images/s ({n} scenes in {wall:.3f} s); per image "
        f"preprocess {pre:.3f} ms, inference {inf:.3f} ms (preprocess "
        f"{row['preprocess_share']:.1%}); {row['detections']} detections; launches "
        f"{launches['deform_fwd']}")
    want = forwards_per_batch * -(-n // batch)
    if launches != no_launches(deform_fwd=want):
        raise SystemExit(f"{name}: deform_fwd did not launch {want} times (once per forward), "
                         f"or another kernel ran: {launches}")
    return results, launches, row


def _serve_clients(model, scenes, want, clients):
    """SERVE_REQUESTS requests from `clients` closed-loop client threads
    (each submits, waits, submits), request k asking for scene k mod n; each
    result must equal the predictor's `want` for its scene, bit for bit.
    Returns (launches, row)."""
    kw = dict(batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS, imgsz=IMGSZ, device=DEVICE)
    with InferenceServer(model, **kw) as warm:  # warms the server's stream and shape
        warm.predict(scenes[0])
    srv = InferenceServer(model, **kw).start()
    mismatched = []

    def client(t):
        for k in range(t, SERVE_REQUESTS, clients):
            got = srv.submit(scenes[k % len(scenes)]).result(timeout=600)
            if not np.array_equal(got.boxes.data, want[k % len(scenes)].boxes.data):
                mismatched.append(k)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(clients)]
    reset_counts()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    srv.stop()
    torch.cuda.synchronize()
    launches = read_counts()
    lat = srv.latency_ms()
    row = {"clients": clients, "requests": SERVE_REQUESTS, "images_per_s": SERVE_REQUESTS / wall,
           "p50_ms": lat["p50"], "p90_ms": lat["p90"], "mean_ms": lat["mean"],
           "max_ms": lat["max"], "batches": srv.stats["batches"],
           "mean_occupancy": srv.mean_occupancy}
    log(f"server b{SERVE_BATCH} max_wait {SERVE_WAIT_MS} ms, {clients} client(s): "
        f"{row['images_per_s']:.2f} images/s, latency p50 {lat['p50']:.3f} ms, p90 "
        f"{lat['p90']:.3f} ms, max {lat['max']:.3f} ms; {row['batches']} batches, mean "
        f"occupancy {row['mean_occupancy']:.3f}; launches {launches['deform_fwd']}")
    if lat["n"] != SERVE_REQUESTS or mismatched:
        raise SystemExit(f"server: {lat['n']} of {SERVE_REQUESTS} served, requests "
                         f"{mismatched[:8]} differ from the predictor's result")
    if launches != no_launches(deform_fwd=srv.stats["batches"]):
        raise SystemExit(f"server: deform_fwd did not launch once per batch, or another kernel "
                         f"ran: {launches}")
    return launches, row


def _request_breakdown(model, scenes, batch, reps=5):
    """Where a request of `batch` mixed-size scenes spends its wall time,
    each part ended by a synchronise (median of `reps`): letterbox, upload
    from pinned memory, forward + NMS, download; and the device's busy
    share of forward + NMS (torch.profiler). Returns the row."""
    imgs = scenes[:batch]
    parts = {k: [] for k in ("letterbox", "upload", "forward_nms", "download")}
    with torch.no_grad():
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            x, _ = letterbox_batch(imgs, IMGSZ)
            t1 = time.perf_counter()
            xt = torch.from_numpy(x).pin_memory().to(DEVICE, non_blocking=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            det, counts = infer(model, xt, predictor.CONF, predictor.IOU, predictor.MAX_DET)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            det.float().cpu(), counts.cpu()
            t4 = time.perf_counter()
            for k, a, b in (("letterbox", t0, t1), ("upload", t1, t2),
                            ("forward_nms", t2, t3), ("download", t3, t4)):
                parts[k].append((b - a) * 1e3)
        row = {k: float(np.median(v[1:])) for k, v in parts.items()}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                infer(model, xt, predictor.CONF, predictor.IOU, predictor.MAX_DET)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(device_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    row["device_busy_share"] = busy_us / wall_us
    total = sum(row[k] for k in parts)
    log(f"request of b{batch} ({total:.3f} ms): " +
        ", ".join(f"{k} {row[k]:.3f} ms ({row[k] / total:.1%})" for k in parts) +
        f"; device busy {row['device_busy_share']:.1%} of forward + NMS")
    return row


def phase_serving_entry_points():
    """The fused bf16 flagship behind `DetectionPredictor` (b1, b32, TTA at
    b32) and `InferenceServer` over mixed-size BGR scenes, with the launches
    on each; then float32 on the card against float32 on the CPU through
    the same predictor (plain and TTA). Returns (launches, rows)."""
    log(f"== phase 14: serving entry points (MGDT-n, fused, bf16, letterbox to {IMGSZ} px, "
        f"{N_SCENES} scenes of {', '.join(f'{h}x{w}' for h, w in SCENE_SIZES)})")
    scenes = _scenes(N_SCENES)
    lb_ms = {}
    for h, w in SCENE_SIZES:
        img = scenes[SCENE_SIZES.index((h, w))]
        t0 = time.perf_counter()
        for _ in range(5):
            letterbox(img, IMGSZ)
        lb_ms[f"{h}x{w}"] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"letterbox to {IMGSZ} on the host, ms per image: " +
        ", ".join(f"{k} {v:.3f}" for k, v in lb_ms.items()))
    model = DetectionModel.from_npz(WEIGHTS, device=DEVICE)
    p = _entry_predictor(model, DEVICE, half=True)
    total = no_launches()
    rows = {"letterbox_ms": lb_ms}
    for b in ENTRY_BATCHES:
        _, launches, rows[f"predictor_b{b}"] = _timed_predict(p, scenes, b, f"predictor b{b}")
        total = {k: total[k] + launches[k] for k in total}
    want, _, _ = _timed_predict(p, scenes, SERVE_BATCH, f"predictor b{SERVE_BATCH}")
    p.args.augment = True
    _, launches, rows[f"predictor_tta_b{TTA_BATCH}"] = _timed_predict(
        p, scenes, TTA_BATCH, f"predictor TTA b{TTA_BATCH}", 3)
    total = {k: total[k] + launches[k] for k in total}
    for clients in SERVE_CLIENTS:
        launches, rows[f"server_{clients}"] = _serve_clients(model, scenes, want, clients)
        total = {k: total[k] + launches[k] for k in total}
    for b in (1, SERVE_BATCH):
        rows[f"request_b{b}"] = _request_breakdown(model, scenes, b)
    b1 = rows["predictor_b1"]
    for k, v in lb_ms.items():
        log(f"letterbox share of a b1 request at {k}: {v / (b1['wall_s'] * 1e3 / N_SCENES):.1%}")
    del p, model
    torch.cuda.empty_cache()
    held = {}
    with float32_exact():
        for augment, n in ((False, HOLD_SCENES), (True, HOLD_TTA_SCENES)):
            outs = [_entry_predictor(DetectionModel.from_npz(WEIGHTS, device=dev), dev,
                                     augment=augment)(scenes[:n], batch=8)
                    for dev in (DEVICE, "cpu")]
            held["tta" if augment else "plain"] = _hold_results(
                *outs, f"float32 predictor{' TTA' if augment else ''}, card vs CPU")
    rows["card_vs_cpu_box_px"] = held
    log(f"launches during the serving entry points: {total}")
    return total, rows


# phase 15: a YOLO-format dataset on disk, cut from the seeded scenes at
# phase 14's sizes, JPEG (PIL's encoder, quality 95, 4:2:0)
DISK_TRAIN, DISK_VAL, DISK_HOLD = 64, 16, 8
DISK_NAMES = ("piglet", "sow")
DISK_OVERRIDES = {"optimizer": "SGD", "batch": TRAIN_BATCH, "epochs": 2, "workers": 8}
# the decoder's JPEG limit against cv2's decode (the fixtures' PNG twins):
# the grey levels nvJPEG's IDCT may differ by (3 on the fixtures, on an
# H100), and JAX's mean bound (tests/test_native_loader.py)
JPEG_MAX_DIFF, JPEG_MEAN_DIFF = 3, 0.1
FIXTURES = ROOT / "mgdt_yolo_tpu_torch" / "native" / "fixtures"


def _write_disk_dataset(root):
    """images/{train,val}/imNN.<ext> with their YOLO labels (the scene's
    boxes clipped to the cut, those keeping under a tenth of their area
    dropped) and data.yaml. Returns (yaml path, image format)."""
    from PIL import Image
    fmt = "jpg"
    for split, n, first in (("train", DISK_TRAIN, 0), ("val", DISK_VAL, DISK_TRAIN)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for k in range(n):
            i = first + k
            h, w = SCENE_SIZES[i % len(SCENE_SIZES)]
            item = synthetic_item(i, max(h, w), seed=7)
            img = np.ascontiguousarray(item["img"][:h, :w])
            b = item["boxes"].copy()
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
            keep = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) > 0.1 * area
            rows = [f"{int(c)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                    f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}"
                    for (x1, y1, x2, y2), c in zip(b[keep], item["cls"][keep])]
            path = root / "images" / split / f"im{k:02d}.{fmt}"
            Image.fromarray(img[..., ::-1]).save(path, quality=95)
            (root / "labels" / split / f"im{k:02d}.txt").write_text("\n".join(rows) + "\n")
    y = root / "data.yaml"
    y.write_text(f"path: {root}\ntrain: images/train\nval: images/val\n\nnames:\n" +
                 "".join(f"  {i}: {n}\n" for i, n in enumerate(DISK_NAMES)))
    return y, fmt


def _check_decoder():
    """The decoder on the card against cv2's decode of the committed JPEG
    fixtures (their PNG twins): the largest and mean grey-level differences
    within the stated limit. Returns {fixture: (max, mean)}."""
    out = {}
    if not native.has_jpeg():
        raise SystemExit("the decoder was built without nvJPEG on a machine with a card")
    for j in sorted(FIXTURES.glob("*.jpg")):
        want = native.decode(j.with_suffix(".png"))
        got = native.decode(j)
        if got.shape != want.shape:
            raise SystemExit(f"decoder: {j.name} decodes to {got.shape}, cv2 to {want.shape}")
        d = np.abs(got.astype(np.int16) - want)
        out[j.name] = (int(d.max()), float(d.mean()))
        log(f"decoder {j.name} {got.shape[1]}x{got.shape[0]}: max |diff| {d.max()} grey "
            f"levels, mean {d.mean():.4f}, share > 1: {(d > 1).mean():.4%}")
        if d.max() > JPEG_MAX_DIFF or d.mean() >= JPEG_MEAN_DIFF:
            raise SystemExit(f"decoder: {j.name} is outside the limit (max {JPEG_MAX_DIFF}, "
                             f"mean < {JPEG_MEAN_DIFF})")
    return out


def _decode_ms(paths_by_size):
    """ms per image of `native.decode` alone (5 calls) and of a 32-image
    `decode_batch` on 8 threads, by scene size."""
    rows = {}
    for size, path in paths_by_size.items():
        native.decode(path)
        t0 = time.perf_counter()
        for _ in range(5):
            native.decode(path)
        one = (time.perf_counter() - t0) / 5 * 1e3
        t0 = time.perf_counter()
        native.decode_batch([path] * 32, 8)
        many = (time.perf_counter() - t0) / 32 * 1e3
        rows[size] = {"decode_ms": one, "decode_batch32_ms_per_image": many}
        log(f"decode {size}: {one:.3f} ms one image, {many:.3f} ms per image in a batch of 32 "
            f"(8 threads)")
    return rows


def _train_state(tr):
    return ({k: t.detach() for k, t in tr.train_state().items()},
            (tr.step, tr.ema.updates, tr.optimizer.count, tr.optimizer.mini_step))


def _finite_history(tr, what):
    if not tr.history or not all(math.isfinite(float(m["loss"])) for m in tr.history):
        raise SystemExit(f"{what}: a loss is not finite")


def _expect(launches, what, **want):
    want = no_launches(**want)
    if launches != want:
        raise SystemExit(f"{what} launched {launches}, not {want}")


def _disk_epoch(trainer, repeats=4, workers=None):
    """One timed pass through `train_step` of a train loader over the
    trainer's dataset listed `repeats` times (every file decoded again; a
    fresh iterator, two batches in flight): images/s, the share of the wall
    time the loop waited for the loader (all of it, and after the first
    batch), and the device's idle share (torch.profiler). `workers`: the
    decoder's threads (default the trainer's)."""
    import copy
    ds = copy.copy(trainer.loader.dataset)
    ds.im_files, ds.labels = ds.im_files * repeats, ds.labels * repeats
    loader = DataLoader(ds, TRAIN_BATCH, IMGSZ, seed=0, train=True, device_augment=True,
                        hyp=trainer.args, workers=workers or trainer.args["workers"])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    waits, n = [], 0
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = iter(loader)
        while True:
            tw = time.perf_counter()
            batch = next(it, None)
            waits.append(time.perf_counter() - tw)
            if batch is None:
                break
            trainer.train_step(to_device(batch, DEVICE))
            n += len(batch["img"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(device_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"images": n, "batches": len(loader), "wall_s": wall, "images_per_s": n / wall,
            "first_batch_wait_s": waits[0], "loader_wait_share": sum(waits) / wall,
            "loader_wait_share_after_first": sum(waits[1:]) / (wall - waits[0]),
            "device_idle_share": 1.0 - busy_us / (wall * 1e6)}


def phase_from_disk(resident_step_ms, root):
    """The flagship trained, resumed and served from image files on disk
    (`Trainer(data=...)`, `DetectionPredictor(<directory>)`), with the
    decoder held first; the dataset is written under `root` (phase 16 reads
    it too). Returns (launches, rows)."""
    log(f"== phase 15: from disk (the decoder against the fixtures; a YOLO dataset of "
        f"{DISK_TRAIN} train and {DISK_VAL} val images at "
        f"{', '.join(f'{h}x{w}' for h, w in SCENE_SIZES)}; MGDT-n trained with the JAX "
        f"defaults, b{TRAIN_BATCH}, {IMGSZ} px, 2 epochs, resumed for a third, RMSProp; the "
        f"predictor over the val directory)")
    rows = {"decoder_vs_cv2": _check_decoder()}
    total = no_launches()

    def add(launches):
        for k in total:
            total[k] += launches[k]

    t0 = time.perf_counter()
    data, fmt = _write_disk_dataset(root / "pigs")
    log(f"dataset written as {fmt} in {time.perf_counter() - t0:.2f} s "
        f"({sum(f.stat().st_size for f in (root / 'pigs').rglob('*.' + fmt)) / 2**20:.1f} MiB)")
    rows["format"] = fmt
    rows["decode"] = _decode_ms({f"{h}x{w}": root / "pigs" / "images" / "train" /
                                 f"im{k:02d}.{fmt}" for k, (h, w) in enumerate(SCENE_SIZES)})
    over = {**DISK_OVERRIDES, "data": str(data), "project": str(root / "runs")}
    run = root / "runs" / "run"

    # training, validation every epoch, checkpoints
    model = DetectionModel.from_npz(WEIGHTS, device=DEVICE)
    trainer = Trainer(model, overrides=over, save_dir=run)
    steps, n_val = len(trainer.loader), None
    log(f"train loader: {len(trainer.loader.dataset)} images, {steps} micro-steps an epoch, "
        f"max_gt {trainer.loader.max_gt}, decoder ingest {trainer.loader.native_eligible()}")
    reset_counts()
    t0 = time.perf_counter()
    results = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    add(launches)
    n_val = len(trainer.val_loader)
    epochs = DISK_OVERRIDES["epochs"]
    log(f"trained {epochs} epochs ({epochs * steps} micro-steps, {epochs * n_val} validation "
        f"forwards) in {wall:.2f} s; launches {launches}; validation {results}")
    _expect(launches, "training from disk", deform_fwd=epochs * (steps + n_val),
            deform_bwd=epochs * steps, fused_augment=epochs * steps)
    _finite_history(trainer, "training from disk")
    meta = json.loads((run / "weights" / "last_metadata.json").read_text())
    back = DetectionModel.from_npz(run / "weights" / "last.npz", device=DEVICE)
    want_names = dict(enumerate(DISK_NAMES))
    if meta["names"] != {str(k): v for k, v in want_names.items()} or \
            back.names != want_names or trainer.model.names != want_names:
        raise SystemExit(f"the checkpoint does not carry the dataset's names: {meta['names']}")
    log(f"checkpoint names {back.names}, epoch {meta['epoch']}, step {meta['step']}")
    rows["train_wall_s"] = wall

    # resume for a third epoch: the restored state is the saved one
    saved, saved_counts = _train_state(trainer)
    resumed = Trainer(DetectionModel.from_npz(WEIGHTS, device=DEVICE),
                      overrides={**over, "epochs": epochs + 1, "resume": True}, save_dir=run)
    got, got_counts = _train_state(resumed)
    differ = [k for k in saved if not torch.equal(saved[k], got[k])]
    log(f"resumed from {resumed.resume_path} at epoch {resumed.start_epoch}: counts "
        f"{got_counts} (saved {saved_counts}), {len(got)} tensors, {len(differ)} differ")
    if differ or got_counts != saved_counts or set(got) != set(saved) or \
            resumed.start_epoch != epochs:
        raise SystemExit(f"the resumed state is not the saved one: {differ[:5]}")
    del trainer, saved
    reset_counts()
    resumed.train()
    torch.cuda.synchronize()
    launches = read_counts()
    add(launches)
    _expect(launches, "the resumed epoch", deform_fwd=steps + n_val, deform_bwd=steps,
            fused_augment=steps)
    _finite_history(resumed, "the resumed epoch")
    log(f"resumed epoch: launches {launches}, losses " +
        ", ".join(f"{float(m['loss']):.4f}" for m in resumed.history))

    # the loader's share: a timed pass over the train split, four times over
    rows["train_from_disk"] = _disk_epoch(resumed)
    r = rows["train_from_disk"]
    log(f"train b{TRAIN_BATCH} from disk: {r['images_per_s']:.2f} images/s ({r['images']} "
        f"images, {r['batches']} batches, in {r['wall_s']:.3f} s), loader wait "
        f"{r['loader_wait_share']:.1%} of the wall time (the first batch "
        f"{r['first_batch_wait_s'] * 1e3:.1f} ms; after it "
        f"{r['loader_wait_share_after_first']:.1%}), device idle "
        f"{r['device_idle_share']:.1%}; phase 10's resident augmented micro-step "
        f"{resident_step_ms:.3f} ms = {TRAIN_BATCH / resident_step_ms * 1e3:.2f} images/s")
    rows["resident_step_ms"] = resident_step_ms
    # the decoder's threads share the host's cores with the step: 8, 4
    # and 2 of them, in turns
    sweep = {}
    for w in (8, 4, 2, 2, 4, 8):
        sweep.setdefault(w, []).append(_disk_epoch(resumed, workers=w)["images_per_s"])
    rows["train_from_disk_by_workers"] = sweep
    log("train b32 from disk by decoder threads, in turns (images/s): " +
        ", ".join(f"{w}: {' / '.join(f'{v:.2f}' for v in vs)}" for w, vs in sweep.items()))
    del resumed
    torch.cuda.empty_cache()

    # RMSProp: two micro-steps
    rms = Trainer(DetectionModel.from_npz(WEIGHTS, device=DEVICE),
                  overrides={**over, "optimizer": "RMSProp", "epochs": 1, "val": False})
    reset_counts()
    rms.train()
    torch.cuda.synchronize()
    launches = read_counts()
    add(launches)
    _expect(launches, "RMSProp", deform_fwd=steps, deform_bwd=steps, fused_augment=steps)
    _finite_history(rms, "RMSProp")
    log(f"RMSProp {steps} micro-steps: losses " +
        ", ".join(f"{float(m['loss']):.4f}" for m in rms.history) +
        f"; optimizer {rms.optimizer.kind}, updates {rms.optimizer.count}")
    del rms
    torch.cuda.empty_cache()

    # the predictor over the val directory
    val_dir = root / "pigs" / "images" / "val"
    model = DetectionModel.from_npz(run / "weights" / "last.npz", device=DEVICE)
    p = _entry_predictor(model, DEVICE, half=True)
    files = sorted(val_dir.glob(f"*.{fmt}"))
    for b in ENTRY_BATCHES:
        res, launches, rows[f"predictor_dir_b{b}"] = _timed_predict(
            p, val_dir, b, f"predictor over the directory b{b}", n=len(files))
        add(launches)
        if [r.path for r in res] != [str(f) for f in files]:
            raise SystemExit("the predictor's paths are not the directory's files")
        rows[f"predictor_dir_b{b}"]["decode_letterbox_ms"] = \
            rows[f"predictor_dir_b{b}"]["preprocess_ms"]
    del p, model
    torch.cuda.empty_cache()
    hold = str(val_dir / f"im0[0-{DISK_HOLD - 1}].{fmt}")
    with float32_exact():
        outs = [_entry_predictor(DetectionModel.from_npz(run / "weights" / "last.npz",
                                                         device=dev), dev)(hold, batch=8)
                for dev in (DEVICE, "cpu")]
    rows["card_vs_cpu_box_px"] = _hold_results(
        *outs, f"float32 predictor over {DISK_HOLD} files, card vs CPU")
    log(f"launches during the from-disk path: {total}")
    return total, rows


# phase 16: the facade, the command line, counting over a folder, export
# and AutoBackend, on phase 15's dataset. The float32 card-vs-CPU holds take
# phase 15's limits; AutoBackend is held to the live float32 forward at b1
# and b8, bit for bit expected, else within FACADE_EXPORT_TOL of its magnitude
FACADE_BATCHES = (1, 8)
FACADE_EXPORT_TOL = 1e-5
FACADE_TRAIN = {"epochs": 1}


def _same_bits(got, want, name):
    """The same paths and the same detection rows, bit for bit."""
    if [r.path for r in got] != [r.path for r in want] or any(
            g.boxes.data.shape != w.boxes.data.shape or
            not np.array_equal(g.boxes.data, w.boxes.data) for g, w in zip(got, want)):
        raise SystemExit(f"{name}: the facade's results are not the predictor's bit for bit")
    n = sum(len(r) for r in got)
    log(f"{name}: {len(got)} images, {n} detections, bit for bit the predictor's")
    if n == 0:
        raise SystemExit(f"{name}: no detection to compare")


def _timed(fn):
    """(result, wall s, launches) of one run of `fn` after a synchronise."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def _facade_vs_predictor(val_dir, n):
    """The facade's `predict` against phase 15's `DetectionPredictor` (fused,
    bf16) at b1 and b32, in turns: predictor, facade, facade, predictor.
    Returns (launches of the facade's runs, rows)."""
    from mgdt_yolo_tpu_torch import YOLO
    y = YOLO(WEIGHTS, device=DEVICE)
    p = _entry_predictor(DetectionModel.from_npz(WEIGHTS, device=DEVICE), DEVICE, half=True)
    total, rows = no_launches(), {}
    for b in ENTRY_BATCHES:
        def run_p():
            return p(val_dir, batch=b)

        def run_f():
            return y.predict(val_dir, imgsz=IMGSZ, half=True, batch=b)
        run_p(), run_f()  # warm-up
        times = {"predictor": [], "facade": []}
        for who in ("predictor", "facade", "facade", "predictor"):
            res, wall, launches = _timed(run_p if who == "predictor" else run_f)
            want = -(-n // b)
            if launches != no_launches(deform_fwd=want):
                raise SystemExit(f"{who} b{b}: launched {launches}, not K1 {want} times")
            if who == "facade":
                for k in total:
                    total[k] += launches[k]
            times[who].append(n / wall)
            rows.setdefault(f"results_{who}_b{b}", res)
        _same_bits(rows.pop(f"results_facade_b{b}"), rows.pop(f"results_predictor_b{b}"),
                   f"facade b{b}")
        rows[f"b{b}"] = {"predictor_images_per_s": times["predictor"],
                         "facade_images_per_s": times["facade"]}
        log(f"predict over the directory b{b}, in turns (images/s): predictor "
            f"{' / '.join(f'{v:.2f}' for v in times['predictor'])}, facade "
            f"{' / '.join(f'{v:.2f}' for v in times['facade'])}")
    return y, total, rows


def _cli(args):
    """One command line in its own process: (wall s to its end, stdout)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise SystemExit(f"{' '.join(args[:2])} exited {out.returncode}: {out.stderr[-3000:]}")
    return wall, out.stdout


def _logged_counts(text, pattern):
    return {m.group(1): int(m.group(2)) for m in re.finditer(pattern, text, re.M)}


def _export_round_trip(y, root):
    """npz and pt2 at IMGSZ; AutoBackend over each against the live float32
    forward at FACADE_BATCHES; K1 counted inside the program's forward; the
    program and the eager module timed in turns. Returns (launches, rows)."""
    from mgdt_yolo_tpu_torch.nn.autobackend import AutoBackend
    rows, total = {}, no_launches()
    arts = {}
    for fmt in ("npz", "pt2"):
        t0 = time.perf_counter()
        arts[fmt] = y.export(format=fmt, imgsz=IMGSZ, project=str(root / "export"))[0]
        rows[f"export_{fmt}_s"] = time.perf_counter() - t0
    log(f"exported {arts} in {rows['export_npz_s']:.2f} s (npz) and {rows['export_pt2_s']:.2f} s "
        f"(pt2)")
    live = AutoBackend(y.model, IMGSZ)
    backs = {fmt: AutoBackend(a, IMGSZ, device=DEVICE) for fmt, a in arts.items()}
    for b in FACADE_BATCHES:
        x = torch.rand((b, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(b)
                       ).to(DEVICE)
        want = live(x)
        for fmt, back in backs.items():
            reset_counts()
            got = back(x)
            torch.cuda.synchronize()
            launches = read_counts()
            if launches != no_launches(deform_fwd=1):
                raise SystemExit(f"{fmt} forward b{b} launched {launches}, not K1 once")
            for k in total:
                total[k] += launches[k]
            d = (got - want).abs().max().item()
            scale = max(want.abs().max().item(), 1.0)
            rows[f"{fmt}_b{b}_max_abs_diff"] = d
            log(f"AutoBackend {fmt} b{b}: max |diff| from the live forward {d:.3e} (magnitude "
                f"{scale:.1f}); K1 launched inside it {launches['deform_fwd']} time(s)")
            if d > FACADE_EXPORT_TOL * scale:
                raise SystemExit(f"AutoBackend {fmt} b{b} is not the live forward")
    for b in ENTRY_BATCHES:
        x = torch.rand((b, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(b)
                       ).to(DEVICE)
        ms = {"eager": [], "pt2": []}
        for who in ("eager", "pt2", "pt2", "eager"):
            ms[who].append(cuda_time_ms(lambda: (live if who == "eager" else backs["pt2"])(x),
                                        iters=10, windows=3))
        rows[f"forward_ms_b{b}"] = ms
        log(f"float32 forward b{b}, in turns (ms): eager {' / '.join(f'{v:.3f}' for v in ms['eager'])}"
            f", pt2 {' / '.join(f'{v:.3f}' for v in ms['pt2'])}")
    return arts, total, rows


def phase_facade(root):
    """The `YOLO` facade, the command line and counting over phase 15's val
    directory, export and AutoBackend, and the facade's training. Returns
    (launches, rows)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.cfg import entrypoint
    from mgdt_yolo_tpu_torch.utils.benchmarks import benchmark
    from mgdt_yolo_tpu_torch.utils.counting import cal_counting_metrics, cal_model_count_error
    log(f"== phase 16: the YOLO facade, the command line and counting over phase 15's val "
        f"directory; export to npz and pt2 and AutoBackend; the facade's train, val and "
        f"predict")
    t_phase = time.perf_counter()
    data = root / "pigs" / "data.yaml"
    val_dir = root / "pigs" / "images" / "val"
    n = len(list(val_dir.iterdir()))
    total = no_launches()

    def add(launches):
        for k in total:
            total[k] += launches[k]

    y, launches, rows = _facade_vs_predictor(val_dir, n)
    add(launches)
    hold = str(val_dir / f"im0[0-{DISK_HOLD - 1}].*")
    with float32_exact():
        outs = [YOLO(WEIGHTS, device=dev).predict(hold, imgsz=IMGSZ, batch=8)
                for dev in (DEVICE, "cpu")]
    rows["card_vs_cpu_box_px"] = _hold_results(
        *outs, f"float32 facade over {DISK_HOLD} files, card vs CPU")

    log(f"facade against the predictor and the float32 hold: {time.perf_counter() - t_phase:.1f} s")
    # counting over the directory: the float32 card against the CPU
    counted = {}
    with float32_exact():
        for dev in (DEVICE, "cpu"):
            yd = YOLO(WEIGHTS, device=dev)
            t0 = time.perf_counter()
            if dev == DEVICE:
                reset_counts()
            errs = cal_model_count_error(yd, str(val_dir), imgsz=IMGSZ)
            agree = cal_counting_metrics(yd, str(val_dir), imgsz=IMGSZ)
            if dev == DEVICE:
                torch.cuda.synchronize()
                launches = read_counts()
                add(launches)
                if launches != no_launches(deform_fwd=2 * n):
                    raise SystemExit(f"counting launched {launches}, not K1 {2 * n} times")
                rows["counting_ms_per_image"] = (time.perf_counter() - t0) / (2 * n) * 1e3
            counted[dev] = (errs, agree)
            log(f"counting on {dev}: {time.perf_counter() - t0:.1f} s")
    (ce, ca), (pe, pa) = counted[DEVICE], counted["cpu"]
    log(f"counting on the card (float32): errors {ce}; agreement {ca}; "
        f"{rows['counting_ms_per_image']:.3f} ms per image and function")
    if ce != pe or ca != pa:
        raise SystemExit(f"counting on the card {ce} {ca} is not the CPU's {pe} {pa}")
    rows["counting"] = {"errors": ce, "agreement": {"stats": ca["stats"], "r2": ca["r2"]}}
    log("counting: the card's counts, TP/FP/FN, MAE/MSE/MAPE and R^2 equal the CPU's")

    # the command line: in process (K1 counted), then in its own processes
    reset_counts()
    res = entrypoint(["predict", f"model={WEIGHTS}", f"source={val_dir}", "device=0",
                      f"imgsz={IMGSZ}"])
    torch.cuda.synchronize()
    launches = read_counts()
    add(launches)
    if launches != no_launches(deform_fwd=n) or len(res) != n:
        raise SystemExit(f"entrypoint predict launched {launches} over {len(res)} images")
    want = {r.path: len(r) for r in res}
    wall, text = _cli(["mgdt_yolo_tpu_torch", "predict", f"model={WEIGHTS}",
                       f"source={val_dir}", "device=0", f"imgsz={IMGSZ}"])
    got = _logged_counts(text, r"^(\S+\.\w+): (\d+) detections")
    rows["cli_predict_wall_s"] = wall
    log(f"python -m mgdt_yolo_tpu_torch predict: {wall:.2f} s from start to its last line; "
        f"per-image counts {'equal' if got == want else 'DIFFER'} to the in-process run's")
    if got != want:
        raise SystemExit(f"the command line logged {got}, not {want}")
    wall, text = _cli(["mgdt_yolo_tpu_torch.utils.counting", str(WEIGHTS), str(val_dir),
                       "--metrics", "--conf", "0.25", "--imgsz", str(IMGSZ)])
    got = _logged_counts(text, r"^(\S+\.\w+): (\d+) detections, \d+ labelled")
    rows["cli_counting_wall_s"] = wall
    log(f"python -m mgdt_yolo_tpu_torch.utils.counting --metrics: {wall:.2f} s; per-image "
        f"counts {'equal' if got == want else 'DIFFER'} to the in-process run's")
    if got != want or "count R^2" not in text:
        raise SystemExit(f"the counting command line logged {got}, not {want}")

    # export and AutoBackend
    arts, launches, rows["export"] = _export_round_trip(YOLO(WEIGHTS, device=DEVICE), root)
    add(launches)
    yb = YOLO(WEIGHTS, device=DEVICE)
    yb.overrides["project"] = str(root / "bench")  # where its exports go
    for b in ENTRY_BATCHES:
        reset_counts()
        rows[f"benchmark_b{b}"] = benchmark(yb, imgsz=IMGSZ, formats=["torch", "pt2"], batch=b)
        add(read_counts())
        if not all(r["ok"] for r in rows[f"benchmark_b{b}"]):
            raise SystemExit(f"benchmark b{b} failed: {rows[f'benchmark_b{b}']}")
        log(f"benchmark b{b}: " + "; ".join(f"{r['format']} {r['images_per_sec']:.2f} images/s"
                                             for r in rows[f"benchmark_b{b}"]))

    # the facade trains, validates and predicts: K1, K2 and K3 launch
    yt = YOLO(FLAGSHIP, device=DEVICE)
    reset_counts()
    t0 = time.perf_counter()
    metrics = yt.train(data=str(data), project=str(root / "facade_runs"), **FACADE_TRAIN)
    torch.cuda.synchronize()
    launches = read_counts()
    add(launches)
    steps, n_val = len(yt.trainer.loader), len(yt.trainer.val_loader)
    _expect(launches, "YOLO.train", deform_fwd=steps + n_val, deform_bwd=steps,
            fused_augment=steps)
    _finite_history(yt.trainer, "YOLO.train")
    log(f"YOLO({FLAGSHIP}).train(epochs=1): {steps} micro-steps and {n_val} validation "
        f"forwards in {time.perf_counter() - t0:.2f} s; launches {launches}; {metrics}")
    reset_counts()
    vm = yt.val(data=str(data))
    res = yt.predict(str(val_dir))
    torch.cuda.synchronize()
    launches = read_counts()
    add(launches)
    _expect(launches, "YOLO.val and YOLO.predict",
            deform_fwd=-(-n // TRAIN_DEFAULTS["batch"]) + n)
    log(f"YOLO.val: {vm}; YOLO.predict: {sum(len(r) for r in res)} detections over "
        f"{len(res)} images")
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {rows['phase_s']:.1f} s; launches {total}")
    return total, rows


# which paths run each kernel (its launches must be counted on each); the
# first is the kernel's own main path
KERNEL_PATHS = {"deform_fwd": ("serving", "training", "augmented training",
                               "ablation family", "serving entry points", "from disk",
                               "facade", "K1 variant A/B"),
                "deform_bwd": ("training", "augmented training", "ablation family",
                               "from disk", "facade"),
                "deform_fwd_simt": ("DCN A/B", "K1 variant A/B"),
                "deform_bwd_simt": ("DCN A/B",),
                "fused_augment": ("augmented training", "from disk", "facade", "K3 A/B"),
                "fused_augment_simt": ("K3 A/B",),
                **{name: ("K1 variant A/B",) for name in ALL_VARIANTS}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    kernels, dcn_ab, k3_ab = phase_kernels()
    model, serving = phase_serving()
    phase_throughput(model)
    del model
    trainer, batch, training = phase_training()
    phase_fixed_batch(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    augmented, aug_ms, step_ms = phase_augmented_training()
    torch.cuda.empty_cache()
    phase_card_vs_cpu()
    phase_train_card_vs_cpu()
    phase_augment_card_vs_cpu()
    ablation, ablation_rows = phase_ablation({k["name"]: k["wide"] for k in kernels
                                              if "wide" in k})
    torch.cuda.empty_cache()
    entry, entry_rows = phase_serving_entry_points()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        disk, disk_rows = phase_from_disk(step_ms["augmented"], Path(tmp))
        torch.cuda.empty_cache()
        facade, facade_rows = phase_facade(Path(tmp))
    torch.cuda.empty_cache()
    ab_launches, ab_rows, hopper_rows, plan_rows = phase_variant_ab()
    paths = {"serving": serving, "training": training, "augmented training": augmented,
             "ablation family": ablation, "serving entry points": entry, "from disk": disk,
             "facade": facade,
             "DCN A/B": dcn_ab,
             "K3 A/B": k3_ab, "K1 variant A/B": ab_launches}
    for k in kernels:
        k["launches_by_path"] = {p: paths[p][k["name"]] for p in KERNEL_PATHS[k["name"]]}
        for p, n in k["launches_by_path"].items():
            if not n:
                raise SystemExit(f"kernel {k['name']} never launched on the {p} path")
        # K1's own path is serving, K2's training, K3's augmented training,
        # the SIMT DCN kernels' the DCN A/B, the SIMT K3's the K3 A/B, each
        # variant's the variant A/B
        k["launches"] = k["launches_by_path"][KERNEL_PATHS[k["name"]][0]]
        if k["name"] == "fused_augment":
            k["apply_augment_ms"] = aug_ms
        if k["name"] in ("deform_fwd", "deform_bwd"):
            # its times per launch inside the ablation models' forwards and
            # training steps (profiler), by model
            keys = ("k1_ms_b8", "k1_ms_train") if k["name"] == "deform_fwd" else \
                ("k2_ms_train",)
            k["ablation"] = {n: {"dcn": r["dcn"], **{key: r[key] for key in keys},
                                 "launches": r["launches"][k["name"]]}
                             for n, r in ablation_rows.items() if r["dcn"]}
        if k["name"] == "deform_fwd":
            k["serving_entry_points"] = entry_rows
            k["from_disk"] = disk_rows
            k["facade"] = facade_rows
        if k["name"] in ALL_VARIANTS:
            k["ab"] = [r for r in ab_rows if r["variant"] == k["name"]]
        if k["name"] in FIRST_DESIGNS:
            k["ab_hopper"] = [r for r in hopper_rows if r["variant"] == k["name"]]
        if k["name"] == "deform_fwd_tapwalk":
            k["plans_b512_c64"] = plan_rows
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
