#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mgdt_yolo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:

1. environment: torch, CUDA, the card's name and power limit, every name
   of every port package's `__all__` (the JAX package's package-level
   names, lazily re-exported) with `load_source` and
   `data.dataset.SyntheticDetectionDataset`, imported and counted; numpy
   and scipy, nvcc, triton;
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
   its bound; K1 and K2 at the maps rectangular validation gives them at
   640 px (61x81 and 46x81, C 32) at b8 in the 8 cases, and exact at
   offsets +-8.0 (most corners outside K2's shared-memory window) in both
   types, then each timed in bf16, windowed +-1.5 and exact +-8.0, beside
   its bound;
4. serving path: the flagship MGDT-n from `weights/mgdt_n_synth.npz`, Conv+BN
   fused, bf16, 640 px, answers requests of batch 1, 8 and 32 through
   `predict` on synthetic scenes; K1 must have launched once per forward,
   and no other kernel;
5. serving throughput (images/s) at batch 1, 32 and 128;
6. training path, unaugmented (`cfg.default.UNAUGMENTED`: the host pipeline
   with every augmentation key at 0; no validation):
   the same weights unfused in `train()` mode, bf16 autocast, 640 px, the
   `Trainer` with the JAX defaults (SGD, accumulate 2) over a loader of
   labelled synthetic scenes at batch 32: a few optimizer updates and a
   checkpoint; K1 and K2 must each launch once per micro-step (the SIMT
   kernels and the variants never), every loss be finite and the DCN weight
   get a finite, non-zero gradient;
7. training on one fixed batch: the loss must fall; train images/s at b32;
10. augmented training path: `Trainer.train()` with the JAX defaults but
   `device_augment=True` (mosaic 1.0, scale 0.5, translate 0.1, HSV
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
   matrix (`models.ABLATION`: YOLOv8's PAN with `Detect` at reg_max 4 or
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
   defaults but device augment (validation every epoch, SGD), b32, 640 px, 2
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
   events); `benchmark(formats=["torch", "pt2"])` at b32 (each batch
   exports the pt2 program anew, ~15 s); and
   `YOLO(<flagship YAML>).train(data=..., epochs=1, device_augment=True)`,
   `.val()` and `.predict()` (K3, K2 and K1 once per micro-step, K1 once
   per forward).
17. reference weights, on phase 15's dataset: a reference-layout `.pt`
   (the fork's pickled module graph in fp16, `tools/reference_pt.py`)
   written from the committed npz and loaded by `YOLO(pt)`: its state bit
   for bit the npz's rounded through fp16, pinned exact, no key missed;
   its float32 forward on the card against the CPU (phase 8's limits);
   `predict` in bf16 over the 16 val JPEGs at b1 and b32 in turns with the
   windowed npz model (images/s, K1 per launch under each semantics by
   torch.profiler); `val` in batches of 8, square, `rect=True` and `rect=True,
   save_json=True` in turns (seconds per pass; the batch shapes and the
   DCN's maps, every predictions.json row one of the validator's
   detections, the metrics the same with and without json); one fine-tuning epoch from the `.pt` (exact, device augment; K1,
   K2 and K3 launched, the checkpoint pinned exact), then K1 and K2 per
   launch inside its training step, exact against windowed in turns,
   beside their bounds; and `YOLO(npz).tune` over a space of keys the device
   pipeline honours, with `device_augment=True`, 2 trials of 1 epoch (each in its own run directory, fitness >=
   0, K1, K2 and K3 launched in each). Its launches are the "reference
   weights" path.
18. host augmentation, on phase 15's dataset: the flagship from the committed
   weights through `Trainer.train()` with `device_augment=False` (JAX's
   default: the host pipeline, cv2's arithmetic in numpy with its hot
   loops in C++), b16, 640 px,
   bf16, 2 micro-steps under the JAX defaults and 2 with degrees 10, shear
   2, perspective 0.0005, mixup 0.5, mosaic9 0.5 and copy_paste 0.5 asked
   with `device_augment=True` (the fallback: K1 and K2 once per micro-step,
   K3 never; finite losses; `max_gt` for mosaic9 and mixup); a float32
   training step on 4 images of the first host batch on the card against
   the CPU (phase 13's limits, against the CPU's float64 step); the
   pipeline's items/s with 1 and 8 threads, with its C++ hot loops and
   with their numpy versions; a timed pass of the train loop (images/s, the share of its
   wall time spent waiting for batches, the device's idle share) beside
   phase 15's device path; and one `YOLO.tune` trial drawn from JAX's
   default space (1 epoch, 2 micro-steps and a validation pass; K1 and K2,
   no K3). Its launches are the "host augmentation" path.
19. callbacks and drawing, on phase 15's dataset: `YOLO(npz).train` for 1
   epoch at b16 with `plots=True`, a callback on each of the 25 hooks and
   the MLflow file store on (`MGDT_MLFLOW_DIR`): the trainer's 9 hooks in
   JAX's order, `events.jsonl` one row of JAX's keys, the MLflow run's
   layout, `labels.jpg`, `train_batch0.jpg`, `val_batch0_{labels,pred}.jpg`
   and `confusion_matrix.png` at their sizes, the in-training validation in
   bf16; whether `torch.utils.tensorboard` imports; `.val()` in float32 and
   with `half=True`, each mAP50-95 logged and their detections told apart;
   `.predict(save=True, save_crop=True)` at b1 and b32 against the same
   without `save`, in turns, over phase 15's val JPEGs listed 2 times
   (4 times until PR 26's depth cut; whole batches at b32; images/s, the share of the wall time in
   drawing and encoding); every JPEG it wrote read back through the card's
   decoder and held as the CPU tests hold cv2's reading
   (`draw.jpeg_reading`: within a mean of 1 grey level of
   `draw.jpeg_reference`, and its PSNR at most 0.5 dB below the card's
   reading of libjpeg's own q95 file of the same array, written by PIL).
   Its launches are the "callbacks and drawing" path. Phases 1-18 train and
   validate with `plots=False`, and phases 16-17 validate in bf16
   (`half=True`), as they did before this phase existed.
20. segment and pose: YOLOv8's `yolov8n-seg` (nc 2) and `yolov8n-pose`
   (nc 1) at 640 px from the port's seeded init (no such weights are in
   the repository): a float32 fused forward of two noise images on the
   card against the CPU from BatchNorm statistics of one batch of scenes
   (every raw map, mask coefficient, prototype or raw keypoint within phase
   8's 1e-2 of its magnitude; decoded boxes 0.5 px, the other decoded
   channels 1e-3 of their magnitude; the predictor's NMS, which like JAX's
   takes every channel after the box as a class score, equal on one
   decoded tensor); `YOLO(npz).train` (the seeded init through an npz)
   for 1 epoch of 64 synthetic scenes with their masks or keypoints at
   b16 in bf16 through the host pipeline, with validation, the training
   loop's images/s by the trainer's hooks; `.val()` in float32; the
   predictor (fused, bf16) over 32 mixed-size scenes at b1 and b32; npz
   export, and `YOLO(npz)` and `AutoBackend(npz)` bit for bit the live
   float32 forward. No hand kernel is on this path (the heads wrap
   `Detect`; the segment and pose trainers augment on the host): every
   count must stay 0, and each kernel's row records it
   (`segment_and_pose_launches`). Its lines end with `phase 20 rows:
   {json}`.
21. classify and zoo: the rest of the JAX package's model zoo at 640 px and
   its published widths (YOLOv3, v3-SPP and v3-tiny at their only width,
   YOLOv5n, v5n-P6, v6n, YOLOv8n-P2, -P6 and -pose-P6; default nc), from
   the port's seeded init: each a float32 fused forward of two noise images
   on the card against the CPU at phase 13's limits (raw maps 1e-3 of their
   magnitude, boxes 0.5 px, the other decoded channels 1e-3, NMS equal on
   the same decoded tensor), fused bf16 images/s at b32 (CUDA events, min
   over 3 windows) and two b16 micro-steps through `Trainer.train()`
   (unaugmented, bf16 autocast, finite losses); then `YOLO("yolov8n-cls.yaml")`
   at its published nc 1000 and 224 px in float32 (TF32 off): `train` for
   1 epoch of the synthetic split with validation, `val`, train images/s
   over 16 steps of one resident b64 batch, the predictor over phase 15's
   16 val JPEGs at b1 on the card and on the CPU (top-1 equal,
   probabilities within 1e-4), and npz export with `AutoBackend(npz)` bit
   for bit the live float32 forward. No hand kernel is on this path: every
   count must stay 0 (`classify_and_zoo_launches`). Its lines end with
   `phase 21 rows: {json}`.
22. tracking: `YOLO("weights/mgdt_n_synth.npz").track` over a seeded pan
   of 64 frames at 1080 x 1920 (`data.synthetic.panning_sequence`: a grid
   of synthetic scenes cut by `warp_affine` at known integer and sub-pixel
   offsets), letterboxed to 640 px, with ByteTrack, BoT-SORT (sparse
   optical flow) and BoT-SORT with ECC: in float32 (TF32 off) the card's
   tracks against the CPU's over the first 8 frames and the card's b8
   against its b1 over 16 (IDs and classes equal frame by frame, boxes
   within 0.5 px); in bf16 (Conv+BN fused) frames/s of `track` at b1 and
   b8 over the first 32 frames between two runs of `predict` over the
   same frames (host clock, ended by a synchronise), with each run's
   tracker updates (ms a frame) and GMC calls timed inside it and every H
   held to the known pan
   (translation within 0.1 px at full resolution, the 2 x 2 part within
   1e-3 of the identity); the device's idle share while BoT-SORT runs at
   b1 (torch.profiler, over that timed run). Then BoT-SORT with `gmc_method:
   orb` and with `sift` (the port's ORB and SIFT, `native/src/
   host_features.cpp`): the float32 card's tracks against the CPU's over
   the first 8 frames, the port's GMC on this host over the first 16
   frames against cv2's answer on the CPU (`native/fixtures/gmc/
   pan_h.json`: the frames' digests, ORB's keypoints and descriptors of
   frames 0 and 1 by digest, every H within 1e-4, SIFT's else within 0.25
   px and 2e-3), and bf16 b1 over the 64 frames with its frames/s, GMC and
   update ms (their H are not held to the known pan: cv2's own ORB and SIFT
   miss it by up to 0.86 px, so the fixture holds them). K1 launches once
   per forward on this path and no other kernel (`tracking_launches`). Its
   lines end with `phase 22 rows: {json}`.
23. RT-DETR: `rtdetr-l` at 640 px and its published widths (hd 256, nq
   300, 6 decoder layers, three levels, 8400 tokens, AIFI on the 20x20
   map), nc 80, from the port's seeded init with BatchNorm statistics of
   one batch of scenes: `vit.RTDETR.predict` in bf16 (Conv+BN and the
   input projections' norms folded) over mixed-size BGR scenes at b1, b8
   and b32 (images/s, host clock), the b32 forward alone (CUDA events) and
   the device's idle share under b8 (torch.profiler); its float32 forward
   (TF32 off) of one scene against the CPU's float64 (each of the card's
   top 100 queries within 1e-3, or 4x the CPU's own float32 distance where
   that is larger, of a CPU query on box and scores: near-tied queries may
   swap); the calibrated model written as a reference `.pt`
   (`tools/reference_pt.py`, fp16) and read back through `vit.RTDETR(pt)`
   on the card (write and read seconds; no key missed, the state the
   source's through fp16 bit for bit, the b1 float32 forward, TF32 off, bit
   for bit that of a live model carrying the same rounded state, no kernel
   launched); `RTDETRTrainer` for 4 b8 steps of fresh scenes (bf16 autocast,
   mosaic 0, an update each step; finite losses; each step and its 7
   matcher calls timed, the device's idle share), then one validation on
   the EMA weights (`RTDETRValidator`); `rtdetr-x`, `yolov8n-rtdetr` and
   `models.vocab.VOCABULARY` (every item-17 type) card against CPU. No
   hand kernel is on this path: every count must stay 0
   (`rtdetr_launches`). The phase's seconds are logged by step
   (`steps_s`); its lines end with `phase 23 rows: {json}`.
24. SAM: `vit.sam.SAM("sam_b")` at 1024 px and its published widths (768
   wide, 12 blocks, 12 heads, global attention in blocks 2, 5, 8 and 11,
   14-windows elsewhere, 64x64 tokens) from the port's seeded init (no
   SAM checkpoint is in the repository): the float32 encoder (TF32 off) of
   one 1080x1920 scene against the CPU's float64 (within 1e-3 of its
   magnitude, or 4x the CPU's own float32 distance where that is larger;
   the CPU forwards' seconds printed), a 2-point decode on the card's
   embedding against the CPU's float64 decoder on it (low-res logits 1e-3
   of their magnitude, IoUs 1e-4); the encoder alone at b1 in float32 and
   bf16 (CUDA events, min of 3 windows; the bf16 forward's largest kernels
   by torch.profiler); `SAM.predict` on a 1080x1920 and
   a 480x640 scene split into prep, encode, decode and postprocess (host
   clock, min of 3 runs); `SAM.generate` at points_per_side 8 on the
   480x640 scene at JAX's IoU threshold 0.7 and at the median of the
   seeded model's predicted IoUs (its IoU head predicts near 0: 0.7 keeps
   none), each its wall time, masks kept and the device's idle share by
   torch.profiler; then `data.utils.auto_annotate` with the flagship and
   `sam_b` at 256 px in float32 over phase 15's 16 val JPEGs on the card
   (seconds per image, split into SAM, the contour tracing and the rest),
   and on the CPU over their PNG twins (the card
   decoder's pixels): the same label files, line counts and classes, each
   SAM mask before contouring at least 99.9% the CPU's. No hand kernel is
   on SAM's path: every count must stay 0 (`sam_launches`); auto_annotate's
   detector, the flagship, launches K1 once a forward on the card and no
   other kernel (`auto_annotate_launches`). Its lines end with `phase 24
   rows: {json}`.
25. the public helpers (the "helpers" path): `nn.tasks.attempt_load_weights`
   over the committed flagship and a seeded `gd_thead_yolov8` npz written
   to the temporary directory gives an NMS `Ensemble`, which the predictor
   serves over the 64 seeded scenes at b8 in float32 (TF32 off) and bf16,
   timed: K1 exactly twice a forward, the detections of a batch bit for
   bit NMS over the two members' own decoded outputs, concatenated, and
   the float32 ensemble on 8 scenes held to the CPU's at phase 8's limits;
   `utils.torch_utils.model_info` of the flagship at 640 px on the card (K1
   inside `mgdt::deform_fwd`) and on the CPU (its plain version) must give
   the same layers, parameters and GFLOPs; `Profile` around a b32 bf16
   forward beside CUDA events on the same window; `start_trace` /
   `stop_trace` around a b8 forward, whose Chrome trace must name K1's
   kernel; `utils.checks.check_bf16` on the card; float32 card vs CPU for
   `CBAM`, `heuristic_assign_v2` (b4, the 80x80 anchors), `nms_single` and
   `nms_single_fixpoint` (seeded boxes whose scores tie) and `DyDCNv2` at
   stride 2 (no K1 launch: the plain exact DCN by shape on both devices)
   and at stride 1 without its norm (K1 with its bias). K1 is the only
   kernel on this path (`helpers_launches`). Its lines end with `phase 25
   rows: {json}`.
26. video sources (the "video sources" path): phase 22's pan written as
   Motion JPEG by the port's writer (`native.video.VideoWriter`, 25 fps;
   its ms a frame) to an MP4, and its JPEG bytes to an AVI and an MKV
   written here: each read back with its frame count, fps, size and every
   frame's bytes exact; the MP4's frames decoded by nvJPEG in batches of 8
   (ms a frame, beside phase 15's 1080x1920 JPEG), 4 of them held to
   `draw.jpeg_reading`'s bound; the committed fixtures
   (`native/fixtures/video`, `tests/torch_video_fixtures.py`) against
   their PNG twins: the Motion JPEG clips at phase 15's limits (max 3,
   mean < 0.1), the GIF bit for bit; `YOLO.track` (ByteTrack, bf16) over
   the MP4 at b1 and b8, in turns with the same frames decoded into memory
   (frames/s of each; the tracks bit for bit; K1 once a forward; one
   tracker keyed by the video's path); `predict(save=True)` over the MP4
   at b8, its `pan.mp4` read back (frame count, fps, size); the committed
   MPEG-4 Part 2 and VP8 clips (`pan1080.mp4`, `mp4v`; `pan1080.webm`, VP8;
   `mpeg4_4mv.avi`, 4MV and video packets; three small libvpx variants)
   decoded by the port's own host
   decoders, every frame's SHA-256 cv2's (`codecs.json`), each decoded
   twice (ms a frame, one thread, beside the Motion JPEG frame's), then
   `YOLO.track` over the mp4v clip in turns with its frames in memory as
   above and `predict(save=True)` over it at b8 (frames/s, its video read
   back); a loopback HTTP
   Motion JPEG server in a thread serving the same frames, read through
   `LoadStreams` (frames/s; equal to the file's); the committed WebP
   fixtures (`native/fixtures/webp`, `tests/torch_webp_fixtures.py`) each
   bit for bit cv2's reading (its PNG twin, or for the two full-detail
   1080x1920 scenes, synthetic scene 7 saved lossy at quality 90 and
   lossless, the SHA-256 in `digests.json`), and the decode ms of those
   scenes and of a quality-95 JPEG of the same picture, one image (5
   calls) and 32 on 8 threads, beside phase 15's JPEG; a directory of jpg,
   png, bmp and tif scenes and the two WebP scenes through the predictor,
   bit for bit the detections of the same pixels given as arrays, at least
   one on each WebP scene; one probe line: whether
   `libnvcuvid.so.1` loads and where `nvcuvid.h` / `cuviddec.h` are. K1 is
   the only kernel on this path (`video_launches`). Its lines end with
   `phase 26 rows: {json}`.
   Phase 10 runs before phase 8, and phases 8, 9 and 11 run after it,
   because the CPU work leaves the host's threads busy, which slows the
   host-bound steps; phase 13 runs after phase 11, phase 14 after phase
   13, phase 15 after phase 14, phase 16 after phase 15, phase 17 after
   phase 16, phase 18 after phase 17, phase 19 after phase 18, phase 20
   after phase 19, phase 21 after phase 20, phase 22 after phase 21, phase
   23 after phase 22, phase 24 after phase 23, phase 25 after phase
   24, phase 26 after phase 25, and phase 12, which times kernels only,
   runs last.

The last lines are the kernel table as JSON, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from mgdt_yolo_tpu_torch.cfg.default import CFG_DEFAULTS, TRAIN_DEFAULTS, UNAUGMENTED
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
from mgdt_yolo_tpu_torch.models import ABLATION as ABLATION_CONFIGS
from mgdt_yolo_tpu_torch.models import FLAGSHIP, load_config
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
                                               deform_bwd_bound_ms, deform_fwd_bound_ms,
                                               device_us,
                                               float32_exact, gpu_name_and_power)

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
WEIGHTS = ROOT / "weights" / "mgdt_n_synth.npz"
IMGSZ = 640
DEVICE = "cuda"
TRAIN_BATCH = 32
# the JAX trainer's defaults, with SGD chosen explicitly; batch 32 gives
# accumulate = round(64 / 32) = 2. Phases 6, 7 and 9 train on unaugmented
# scenes without validation, as they did before the augmented path existed.
# Phases 1-18 train and validate with `plots=False` (NO_PLOTS), as they did
# before the port drew: drawing is phase 19's to measure
NO_PLOTS = {"plots": False}
TRAIN_OVERRIDES = {"optimizer": "SGD", "batch": TRAIN_BATCH, "epochs": 1, "val": False,
                   **UNAUGMENTED, **NO_PLOTS}
# phase 10: the JAX defaults but device augment (validation every epoch)
AUG_EPOCHS, AUG_STEPS = 2, 2
AUG_OVERRIDES = {"optimizer": "SGD", "batch": TRAIN_BATCH, "epochs": AUG_EPOCHS,
                 "close_mosaic": 1, "device_augment": True, **NO_PLOTS}
# phase 22: the pan, the trackers, the frames held, the limits
TRACK_FRAMES, TRACK_SHAPE, TRACK_BATCHES = 64, (1080, 1920), (1, 8)
TRACK_TRACKERS = ("bytetrack", "botsort", "botsort_ecc")
TRACK_HOLD_FRAMES, TRACK_B8_FRAMES = 8, 16    # card vs CPU; b8 vs b1 (float32, card)
TRACK_TIMED_FRAMES = 32                       # bf16 predict and the first three trackers
TRACK_BOX_PX = 0.5                            # track boxes, card vs CPU and b8 vs b1
TRACK_GMC_PX, TRACK_GMC_LINEAR = 0.1, 1e-3    # the GMC's H against the known pan
# BoT-SORT with the ORB and SIFT GMC: cv2's H over the pan's first frames
# (tests/torch_gmc_fixtures.py), the port's held to it
TRACK_FEATURE_TRACKERS = ("botsort_orb", "botsort_sift")
PAN_H = ROOT / "mgdt_yolo_tpu_torch" / "native" / "fixtures" / "gmc" / "pan_h.json"
TRACK_FEATURE_H = 1e-4                        # ORB's H, and SIFT's on cv2's matches
TRACK_SIFT_PX, TRACK_SIFT_LINEAR = 0.25, 2e-3  # SIFT's H where its matches are not cv2's
# every variant kernel: the five variants (by their Hopper designs) and
# their first designs, each (wrapper, plain version)
ALL_VARIANTS = {**VARIANTS, **{simt: (fn, plain) for simt, fn, plain in FIRST_DESIGNS.values()}}
# the port's packages whose `__all__` phase 1 imports: every package the
# JAX package re-exports names from (`tests/test_torch_package_names.py`)
PORT_PACKAGES = ("", "cfg", "data", "engine", "native", "nn", "nn.modules", "ops", "tracker",
                 "utils", "vit", "vit.rtdetr", "vit.sam")
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


def _package_names():
    """Every name of every port package's `__all__` (the JAX package's
    package-level names, re-exported lazily), each imported, with
    `engine.predictor.load_source` and `data.dataset.SyntheticDetectionDataset`.
    Returns (packages, names)."""
    import importlib
    count = 0
    for pkg in PORT_PACKAGES:
        mod = importlib.import_module("mgdt_yolo_tpu_torch" + (f".{pkg}" if pkg else ""))
        for name in mod.__all__:
            getattr(mod, name)  # an import that fails ends the script
        count += len(mod.__all__)
    for pkg, name in (("engine.predictor", "load_source"),
                      ("data.dataset", "SyntheticDetectionDataset")):
        getattr(importlib.import_module(f"mgdt_yolo_tpu_torch.{pkg}"), name)
        count += 1
    return len(PORT_PACKAGES), count


def phase_environment():
    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    packages, names = _package_names()
    log(f"package names: {names} names of {packages} packages imported "
        f"({time.perf_counter() - t0:.2f} s)")
    log(f"gpu: {gpu_name_and_power()}")
    import scipy
    log(f"numpy {np.__version__}  scipy {scipy.__version__}")
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


# the stride-8 maps K1 and K2 take under rectangular validation at 640 px
# (phase 17): phase 15's landscape scenes plan 488x648 (480x640, 375x500)
# and 368x648 (720x1280, 1080x1920) batches at the flagship's stride 8 and
# pad 0.5; held at b8 in phase 3's 8 cases, and under exact semantics also
# at offsets +-8.0, where most corners leave K2's shared-memory window
RECT_MAPS = ((61, 81), (46, 81))
FAR_OFFSETS = 8.0


def _check_rect_maps(B=8, C=32, O=32):
    """K1 and K2 at RECT_MAPS against their plain versions in phase 3's 8
    cases (`_hold_fwd`'s and `_hold_bwd`'s limits) and exact at offsets
    +-FAR_OFFSETS in both types; then each timed in bf16 at b8, windowed at
    +-1.5 and exact at +-FAR_OFFSETS, beside its bound. Returns
    {kernel: {"HxW": row}}."""
    out = {"deform_fwd": {}, "deform_bwd": {}}
    cases = DCN_CASES + [(dtype, "exact", FAR_OFFSETS)
                         for dtype in (torch.float32, torch.bfloat16)]
    kernels = (("deform_fwd", cuda_deform.deform_fwd, deform_fwd_bound_ms),
               ("deform_bwd", cuda_deform.deform_bwd, deform_bwd_bound_ms))
    for H, W in RECT_MAPS:
        rows = {name: {} for name, _, _ in kernels}
        for dtype, semantics, off_range in cases:
            args = _deform_inputs(B, H, W, C, O, off_range, dtype)
            g = _deform_grad(B, H, W, O, dtype)
            case = f"{_case_label(dtype, semantics, off_range, B)} {H}x{W}"
            key = f"max_abs_err_{str(dtype)[6:]}_{semantics}_{off_range}"
            rows["deform_fwd"][key] = _hold_fwd("deform_fwd", cuda_deform.deform_fwd, args,
                                                semantics, case)
            rows["deform_bwd"][key] = _hold_bwd("deform_bwd", cuda_deform.deform_bwd, args, g,
                                                semantics, case)
            del args, g
        for name, fn, bound in kernels:
            for semantics, off_range in (("windowed", 1.5), ("exact", FAR_OFFSETS)):
                args = _deform_inputs(B, H, W, C, O, off_range, torch.bfloat16)
                if name == "deform_bwd":
                    args.append(_deform_grad(B, H, W, O, torch.bfloat16))
                ms = cuda_time_ms(lambda: fn(*args, semantics=semantics), iters=10, windows=3)
                bound_ms, bound_by = bound(B, H, W, C, O, "bfloat16")
                rows[name][f"ms_{semantics}_{off_range}"] = ms
                rows[name].update(bound_ms=bound_ms, bound_by=bound_by)
                log(f"{name} rect map b{B} {H}x{W} bf16 {semantics} offsets +-{off_range}: "
                    f"{ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.2%} "
                    f"of it")
                del args
            out[name][f"{H}x{W}"] = rows[name]
        torch.cuda.empty_cache()
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
        bounds = {"deform_fwd": deform_fwd_bound_ms, "deform_bwd": deform_bwd_bound_ms}
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
                            modulated_deform_conv2d_plain_bwd, deform_bwd_bound_ms)}
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
    rect = _check_rect_maps()
    dcn = _dcn_entries(H, W, C, O, errs, rows)
    for e in dcn:
        if e["name"] in wide:
            e["wide"] = wide[e["name"]]
        if e["name"] in rect:
            e["rect_maps"] = rect[e["name"]]
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


def _serving_card_vs_cpu(load, what):
    """A fused float32 forward and NMS of scenes 4 and 5 at 640 px (two
    that have detections) on the card and on the CPU (plain DCN), the model
    from `load(device)`, TF32 off: raw maps within 1e-2, the same NMS counts
    (some detections) and boxes within 0.5 px. Returns the differences."""
    x = torch.from_numpy(synthetic_batch(6, IMGSZ)[4:]).float() / 255.0
    outs = []
    for dev in (DEVICE, "cpu"):
        model = load(dev).fuse()
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
    log(f"{what}: raw map max |diff| {raw_err:.3e} (max |raw| {fc.abs().max().item():.3f}), "
        f"decoded max |diff| {dec_err:.3e}")
    log(f"{what}: NMS counts card {cg.tolist()} cpu {cc.tolist()}; box max |diff| {box_err}")
    # float32 without TF32 on both: differences are rounding of reordered sums
    if not (raw_err < 1e-2 and same_counts and int(cc.sum()) > 0 and box_err < 0.5):
        raise SystemExit(f"{what}: the card and the CPU disagree")
    return {"raw_max_abs_diff": raw_err, "decoded_max_abs_diff": dec_err,
            "box_max_abs_diff": box_err, "detections": int(cc.sum())}


def phase_card_vs_cpu():
    log("== phase 8: serving in float32 on the card against float32 on the CPU")
    _serving_card_vs_cpu(lambda dev: DetectionModel.from_npz(WEIGHTS, device=dev),
                         "the npz model")


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


def _float32_train_step(dev, batch, fault=None, name=None, dtype=torch.float32):
    """Loss parts and the `grad_names` gradients of one float32 training
    forward and backward on `dev`: of the flagship from its weights, or of
    the config `name` (nc=2) from the port's seeded init; `fault` plants
    `_planted(fault)` into the DCN's backward. `dtype=torch.float64` (the
    CPU only) runs the model in float64 (the loss takes its maps in
    float32 as always)."""
    model = (DetectionModel.from_npz(WEIGHTS, device=dev) if name is None else
             DetectionModel(name, nc=ABLATION_NC, device=dev)).train().to(dtype)
    crit = Trainer(model, overrides={**TRAIN_OVERRIDES, "amp": False},
                   steps_per_epoch=1).criterion
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in to_device(batch, dev).items()}
    real = cuda_deform.deform_bwd
    if fault:
        cuda_deform.deform_bwd = lambda *a: _planted(fault)(*real(*a))
    try:
        with float32_exact():
            out = crit(model.forward_feats(b["img"].to(dtype) / 255.0), b, 0)
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
ABLATION = tuple(n for n in ABLATION_CONFIGS if n != FLAGSHIP)
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
    torch.profiler (the kernels' own device time, not the host's gaps). It
    records the device's activity alone: the host's operators of a training
    step or a predictor over files are tens of thousands of events, whose
    table costs seconds each time, and no reading here uses them."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
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


def _calibrated_state(name, nc=ABLATION_NC):
    """`name`'s seeded init (`nc` classes) with every BatchNorm's statistics set to those
    of one batch of synthetic scenes (one train-mode forward at momentum 1).
    At the plain seeded init the deep features are so small that every
    anchor of a level scores its class prior to float32 rounding, so NMS
    would order ties by rounding."""
    model = DetectionModel(name, nc=nc, device=DEVICE).train()
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
DISK_OVERRIDES = {"optimizer": "SGD", "batch": TRAIN_BATCH, "epochs": 2, "workers": 8,
                  "device_augment": True, **NO_PLOTS}
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


def _timed_train_loop(trainer, loader, profile=True):
    """One timed pass of `trainer.train_step` over `loader` (a fresh
    iterator, two batches in flight): images/s (over the whole pass, and
    with the wait for the first batch taken out), the share of the wall
    time the loop waited for the loader (all of it, and after the first
    batch), and the device's idle share (torch.profiler, the device's
    activity alone, as `_profiled_ms` records it; None without `profile`,
    which spares the profiler's seconds of event processing)."""
    waits, n = [], 0
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) \
        if profile else contextlib.nullcontext()
    with prof:
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
                  if e.device_type == torch.autograd.DeviceType.CUDA) if profile else None
    return {"images": n, "batches": len(loader), "wall_s": wall, "images_per_s": n / wall,
            "images_per_s_after_first": n / (wall - waits[0]),
            "first_batch_wait_s": waits[0], "loader_wait_share": sum(waits) / wall,
            "loader_wait_share_after_first": sum(waits[1:]) / (wall - waits[0]),
            "device_idle_share": None if busy_us is None else 1.0 - busy_us / (wall * 1e6)}


def _repeated(dataset, repeats):
    """A copy of a file dataset that lists its files `repeats` times (every
    file decoded again)."""
    ds = copy.copy(dataset)
    ds.im_files, ds.labels = ds.im_files * repeats, ds.labels * repeats
    return ds


def _disk_epoch(trainer, repeats=4, workers=None, dataset=None):
    """`_timed_train_loop` over a train loader, routed and batched as the
    trainer's, of `dataset` (default the trainer's) listed `repeats` times.
    `workers`: the loader's threads (default the trainer's)."""
    ds = _repeated(dataset or trainer.loader.dataset, repeats)
    loader = DataLoader(ds, trainer.args["batch"], IMGSZ, seed=0, train=True,
                        device_augment=trainer.device_augment, hyp=trainer.args,
                        workers=workers or trainer.args["workers"])
    return _timed_train_loop(trainer, loader)


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
FACADE_TRAIN = {"epochs": 1, "device_augment": True, **NO_PLOTS}
# `benchmark`'s batches (each exports the pt2 program anew)
FACADE_BENCH_BATCHES = (32,)


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
    for b in FACADE_BENCH_BATCHES:
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
    vm = yt.val(data=str(data), half=True)  # bf16, as before the dtype repair
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


# phase 17: reference weights. A reference-layout .pt (the fork's pickled
# module graph, fp16; tools/reference_pt.py) written from the committed npz
# and loaded by `YOLO(pt)`, which pins it to exact deform semantics, on
# phase 15's dataset. Validation in batches of 8 plans phase 15's 16
# landscape val images into a 368x648 and a 488x648 batch (RECT_MAPS)
REF_VAL_BATCH = 8
# keys the trainer and the device augmentation honour (the JAX default
# space's degrees, shear, perspective, mixup and copy_paste route a trial to
# the host pipeline: phase 18 tunes over that space)
REF_TUNE_SPACE = {"lr0": (1e-4, 1e-2), "momentum": (0.8, 0.95), "box": (5.0, 10.0),
                  "cls": (0.3, 1.0), "hsv_h": (0.0, 0.03), "hsv_s": (0.3, 0.9),
                  "translate": (0.0, 0.2), "scale": (0.2, 0.6), "fliplr": (0.0, 0.5)}
REF_TUNE_TRIALS = 2


def _json_rows_hold(pred_json, validator):
    """Every predictions.json row is one of the validator's detections: per
    image, in order, the COCO row of each detection (xyxy in the image's
    pixels -> top-left xywh rounded to 3 decimals, the score to 5, the
    class as category); no row of another image. Returns the row count."""
    by_image = {}
    for r in json.loads(Path(pred_json).read_text()):
        by_image.setdefault(r["image_id"], []).append(r)
    n = 0
    for det, path in zip(validator.per_image_preds, validator.per_image_paths):
        stem = Path(path).stem
        image_id = int(stem) if stem.isnumeric() else stem
        want = []
        for x1, y1, x2, y2, conf, cls in det.astype(np.float64).tolist():
            box = [(x1 + x2) / 2 - (x2 - x1) / 2, (y1 + y2) / 2 - (y2 - y1) / 2, x2 - x1, y2 - y1]
            want.append({"image_id": image_id, "category_id": int(cls),
                         "bbox": [round(v, 3) for v in box], "score": round(conf, 5)})
        if by_image.pop(image_id, []) != want:
            raise SystemExit(f"predictions.json: the rows of {image_id!r} are not the "
                             f"validator's {len(want)} detections")
        n += len(want)
    if by_image or n == 0:
        raise SystemExit(f"predictions.json holds rows of no validated image: {list(by_image)}")
    return n


# each validation pass of phase 17 and its keys
VAL_KINDS = {"square": {}, "rect": {"rect": True},
             "rect_json": {"rect": True, "save_json": True}}


def _timed_val(y, data, kind, root, maps):
    """One validation pass of the facade over the val split (batch
    REF_VAL_BATCH, VAL_KINDS[kind]; bf16 with `half=True` and no plots, as
    these passes ran before the standalone validator's float32 default):
    (seconds, results, launches); `maps` collects the DCN's (b, h, w) per
    forward."""
    maps.clear()
    kw = {**VAL_KINDS[kind], "save_dir": root / f"val_{kind}", "half": True, **NO_PLOTS}
    out, wall, launches = _timed(lambda: y.val(data=str(data), imgsz=IMGSZ,
                                               batch=REF_VAL_BATCH, **kw))
    return wall, out, launches


def phase_reference_weights(root):
    """A reference `.pt` through the facade: its state, the float32 card
    against the CPU, prediction and validation (rectangular, COCO json)
    under exact semantics beside the windowed npz model, a fine-tuning
    epoch with K2 exact against windowed, and the tuner. Returns (launches,
    rows)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.tools.reference_pt import write_reference_pt
    log(f"== phase 17: reference weights (a reference-layout .pt written from the committed "
        f"npz, YOLO(pt) pinned exact) on phase 15's dataset: predict, rect val with COCO json, "
        f"a fine-tuning epoch, {REF_TUNE_TRIALS} tune trials")
    t_phase = time.perf_counter()
    data = root / "pigs" / "data.yaml"
    val_dir = root / "pigs" / "images" / "val"
    n = len(list(val_dir.iterdir()))
    total, rows = no_launches(), {"steps_s": {}}
    t_lap = [t_phase]

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def lap(step):
        """The seconds `step` took, on the host's clock, into rows."""
        now = time.perf_counter()
        rows["steps_s"][step] = now - t_lap[0]
        log(f"[phase 17: {step} took {now - t_lap[0]:.2f} s]")
        t_lap[0] = now

    # the checkpoint: the npz's state rounded through fp16, pinned exact, no miss
    src = DetectionModel.from_npz(WEIGHTS, device="cpu")
    t0 = time.perf_counter()
    pt = write_reference_pt(src, root / "reference" / "best.pt")
    t1 = time.perf_counter()
    y = YOLO(pt, device=DEVICE)
    t2 = time.perf_counter()
    report = y.model.import_report
    want = {k: v.half().float() if v.is_floating_point() else v
            for k, v in src.state_dict().items()}
    got = {k: v.cpu() for k, v in y.model.state_dict().items()}
    differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
    rows["checkpoint"] = {"bytes": pt.stat().st_size, "write_s": t1 - t0, "load_s": t2 - t1,
                          "matched": report["matched"],
                          "shape_missed": len(report["shape_missed"]),
                          "name_missed": len(report["name_missed"]), "tensors_differ": len(differ),
                          "semantics": y.model.deform_semantics}
    log(f"reference .pt: {pt.stat().st_size / 2**20:.2f} MiB written in {t1 - t0:.2f} s, "
        f"YOLO(pt) in {t2 - t1:.2f} s; import {report['matched']} matched, "
        f"{len(report['shape_missed'])} shape-missed, {len(report['name_missed'])} name-missed; "
        f"{len(differ)} of {len(want)} tensors differ from the npz's rounded through fp16; "
        f"semantics {y.model.deform_semantics}; config {y.overrides['model']}")
    if differ or set(got) != set(want) or report["shape_missed"] or report["name_missed"] or \
            y.model.deform_semantics != "exact":
        raise SystemExit(f"the .pt model is not the npz's state through fp16, pinned exact: "
                         f"{differ[:5]} {report}")

    # the float32 forward on the card against the CPU, phase 8's limits
    lap("checkpoint")
    rows["card_vs_cpu"] = _serving_card_vs_cpu(
        lambda dev: DetectionModel.from_pt(pt, device=dev)[0], "the .pt model (exact)")
    lap("card_vs_cpu")

    # predict over the val JPEGs in bf16: exact (.pt) and windowed (npz), in turns
    preds = {"windowed": _entry_predictor(DetectionModel.from_npz(WEIGHTS, device=DEVICE),
                                          DEVICE, half=True),
             "exact": _entry_predictor(DetectionModel.from_pt(pt, device=DEVICE)[0], DEVICE,
                                       half=True)}
    for b in ENTRY_BATCHES:
        ips = {"windowed": [], "exact": []}
        for sem in ("windowed", "exact", "exact", "windowed"):
            _, launches, row = _timed_predict(preds[sem], val_dir, b,
                                              f"predict b{b} {sem}", n=n)
            add(launches)
            ips[sem].append(row["images_per_s"])
        k1 = {sem: _profiled_ms(lambda: preds[sem](val_dir, batch=b), 2)["deform_fwd"]
              for sem in ("windowed", "exact")}
        bound_ms, bound_by = deform_fwd_bound_ms(min(b, n), IMGSZ // 8, IMGSZ // 8, 32, 32,
                                                 "bfloat16")
        rows[f"predict_b{b}"] = {"images_per_s": ips, "k1_ms": k1, "k1_bound_ms": bound_ms,
                                 "k1_bound_by": bound_by}
        log(f"predict b{b} over {n} JPEGs, in turns (images/s): windowed "
            f"{' / '.join(f'{v:.2f}' for v in ips['windowed'])}, exact "
            f"{' / '.join(f'{v:.2f}' for v in ips['exact'])}; K1 per launch (profiler) "
            f"windowed {k1['windowed']:.4f} ms, exact {k1['exact']:.4f} ms at "
            f"({min(b, n)}, {IMGSZ // 8}, {IMGSZ // 8}, 32) bf16, bound {bound_ms:.5f} ms "
            f"({bound_by})")
    del preds
    torch.cuda.empty_cache()
    lap("predict")

    # validation: square, rectangular, rectangular with COCO json, in turns
    dcn_maps = []
    hook = _dcn(y.model).register_forward_hook(
        lambda m, inp, out: dcn_maps.append((inp[0].shape[0], *inp[0].shape[2:])))
    secs = {kind: [] for kind in VAL_KINDS}
    for kind in ("square", "rect", "rect_json", "rect_json", "rect", "square"):
        wall, results, launches = _timed_val(y, data, kind, root / "reference", dcn_maps)
        add(launches)
        secs[kind].append(wall)
        want_k1 = -(-n // REF_VAL_BATCH)
        if launches != no_launches(deform_fwd=want_k1):
            raise SystemExit(f"{kind} val launched {launches}, not K1 {want_k1} times")
        if kind == "rect_json":
            shapes = [tuple(s) for s in y.validator.batch_shapes]
            maps = sorted(set(dcn_maps))
            rows_json = _json_rows_hold(y.validator.pred_json, y.validator)
            rows["val_rect_json"] = {"batch_shapes": shapes, "k1_maps": maps,
                                     "results": {k: float(v) for k, v in results.items()},
                                     "json_rows": rows_json}
            log(f"rect val: batch shapes {shapes}, K1 at (b, h, w) {maps}; {rows_json} "
                f"predictions.json rows, each the validator's detection; {results}")
            if sorted({(h // 8, w // 8) for h, w in shapes}) != sorted(RECT_MAPS) or \
                    sorted({m[1:] for m in maps}) != sorted(RECT_MAPS):
                raise SystemExit(f"rect val did not run the planned maps {RECT_MAPS}: {maps}")
        else:
            rows[f"val_{kind}"] = {"results": {k: float(v) for k, v in results.items()}}
    hook.remove()
    rows["val_s"] = secs
    log(f"validation pass over {n} images, in turns (s): " + "; ".join(
        f"{kind} {' / '.join(f'{v:.3f}' for v in secs[kind])}" for kind in VAL_KINDS))
    if {**rows["val_rect"]["results"], "speed_ms_per_image": 0} != \
            {**rows["val_rect_json"]["results"], "speed_ms_per_image": 0}:
        raise SystemExit("save_json changed the rect validation's metrics")
    lap("validate")

    # a fine-tuning epoch from the .pt (exact, device augment)
    reset_counts()
    t0 = time.perf_counter()
    metrics = y.train(data=str(data), epochs=1, imgsz=IMGSZ, device_augment=True,
                      project=str(root / "reference" / "runs"), **NO_PLOTS)
    torch.cuda.synchronize()
    launches = read_counts()
    add(launches)
    tr = y.trainer
    steps, n_val = len(tr.loader), len(tr.val_loader)
    _expect(launches, "fine-tuning the .pt", deform_fwd=steps + n_val, deform_bwd=steps,
            fused_augment=steps)
    _finite_history(tr, "fine-tuning the .pt")
    meta = json.loads((tr.save_dir / "weights" / "last_metadata.json").read_text())
    log(f"fine-tuned 1 epoch from the .pt: {steps} micro-steps, {n_val} validation forwards in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}; checkpoint semantics "
        f"{meta['deform_semantics']}; {metrics}")
    if meta["deform_semantics"] != "exact" or y.model.deform_semantics != "exact":
        raise SystemExit("fine-tuning the .pt left its exact pin")
    lap("fine_tune")
    # K1 and K2 per launch inside the training step, exact against windowed in turns
    b = to_device(next(iter(tr.loader)), DEVICE)
    per = {"exact": [], "windowed": []}
    tr.model.train()
    for sem in ("exact", "windowed", "windowed", "exact"):
        tr.model.set_deform_semantics(sem)
        per[sem].append(_profiled_ms(lambda: tr.train_step(b), 4))
    tr.model.set_deform_semantics("exact").eval()
    B = int(b["img"].shape[0])
    k1_bound, k1_by = deform_fwd_bound_ms(B, IMGSZ // 8, IMGSZ // 8, 32, 32, "bfloat16")
    k2_bound, k2_by = deform_bwd_bound_ms(B, IMGSZ // 8, IMGSZ // 8, 32, 32, "bfloat16")
    rows["train_step"] = {
        "batch": B, "k1_ms": {s: [r["deform_fwd"] for r in v] for s, v in per.items()},
        "k2_ms": {s: [r["deform_bwd"] for r in v] for s, v in per.items()},
        "k1_bound_ms": k1_bound, "k1_bound_by": k1_by, "k2_bound_ms": k2_bound,
        "k2_bound_by": k2_by, "steps": steps, "n_val": n_val}
    r = rows["train_step"]
    log(f"training step b{B} (bf16 autocast), per launch in turns (profiler): K2 exact "
        f"{' / '.join(f'{v:.4f}' for v in r['k2_ms']['exact'])} ms, windowed "
        f"{' / '.join(f'{v:.4f}' for v in r['k2_ms']['windowed'])} ms (bound {k2_bound:.5f} "
        f"ms, {k2_by}); K1 exact {' / '.join(f'{v:.4f}' for v in r['k1_ms']['exact'])} ms, "
        f"windowed {' / '.join(f'{v:.4f}' for v in r['k1_ms']['windowed'])} ms (bound "
        f"{k1_bound:.5f} ms, {k1_by})")
    del tr, b
    torch.cuda.empty_cache()
    lap("train_step_profile")

    # the tuner over keys the port honours, on the windowed npz model
    yt = YOLO(WEIGHTS, device=DEVICE)
    trials, train = [], yt.train

    def counted_train(**kw):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = train(**kw)
        torch.cuda.synchronize()
        trials.append({"name": kw["name"], "launches": read_counts(),
                       "wall_s": time.perf_counter() - t0, "fitness": out.get("fitness")})
        return out
    yt.train = counted_train
    project = root / "reference" / "tune"
    best, fit, history = yt.tune(data=str(data), space=REF_TUNE_SPACE,
                                 max_samples=REF_TUNE_TRIALS,
                                 train_args={"epochs": 1, "imgsz": IMGSZ,
                                             "device_augment": True,
                                             "project": str(project), **NO_PLOTS})
    for t in trials:
        add(t["launches"])
        log(f"tune trial {t['name']}: {t['wall_s']:.2f} s, fitness {t['fitness']:.5f}, "
            f"launches {t['launches']}")
        if not all(t["launches"][k] for k in ("deform_fwd", "deform_bwd", "fused_augment")) \
                or not t["fitness"] >= 0 or not (project / t["name"] / "results.csv").is_file():
            raise SystemExit(f"tune trial {t['name']} did not train through K1, K2 and K3 into "
                             f"its own directory with a fitness: {t}")
    if len(trials) != REF_TUNE_TRIALS or len(history) != REF_TUNE_TRIALS:
        raise SystemExit(f"the tuner ran {len(trials)} trials, not {REF_TUNE_TRIALS}")
    rows["tune"] = {"trials": [{k: v for k, v in t.items() if k != "launches"} for t in trials],
                    "best_fitness": fit, "best": best}
    log(f"tune: best fitness {fit:.5f} with {best}")
    lap("tune")
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {rows['phase_s']:.1f} s; launches {total}")
    return total, rows


# phase 18: the host augmentation pipeline (`device_augment=False`, JAX's
# default) on phase 15's dataset: HOST_STEPS micro-steps at HOST_BATCH under
# the JAX defaults, as many with every key only the host pipeline honours
# (asked with `device_augment=True`, which falls back with JAX's warning), the
# float32 step on HOST_HOLD images of the first host batch card vs CPU at
# phase 13's limits, then timed passes over the train split listed several
# times: the pipeline's items/s by thread count (HOST_THREADS: threads ->
# times listed), the host path's train loop (its wait share) and the device
# path's at the same batch size (HOST_REPEATS times); and one tune trial from
# JAX's default space
HOST_BATCH, HOST_STEPS, HOST_HOLD, HOST_REPEATS = 16, 2, 4, 4
HOST_ALL_ON = {"degrees": 10.0, "shear": 2.0, "perspective": 0.0005, "mixup": 0.5,
               "mosaic9": 0.5, "copy_paste": 0.5}
HOST_THREADS = {1: 2, 8: 4}


def _host_overrides(data, root, **kw):
    """The JAX defaults on phase 15's dataset, the share of its train split
    that makes HOST_STEPS batches, no validation."""
    return {"data": str(data), "batch": HOST_BATCH, "epochs": 1, "val": False,
            "fraction": HOST_BATCH * HOST_STEPS / DISK_TRAIN, "optimizer": "SGD",
            "workers": 8, "project": str(root), **NO_PLOTS, **kw}


def _host_train(over, run, what):
    """`Trainer.train()` of the flagship on the host path (counted): K1 and
    K2 once a micro-step, K3 never; finite losses. Returns (trainer,
    launches, wall seconds)."""
    trainer = Trainer(DetectionModel.from_npz(WEIGHTS, device=DEVICE), overrides=over,
                      save_dir=run)
    loader = trainer.loader
    if trainer.device_augment or not loader.host_augment or trainer.augment_fn is not None:
        raise SystemExit(f"{what}: the trainer did not take the host pipeline")
    steps = len(loader)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    _expect(launches, what, deform_fwd=steps, deform_bwd=steps)
    _finite_history(trainer, what)
    log(f"{what}: {steps} micro-steps of b{HOST_BATCH} in {wall:.2f} s "
        f"({steps * HOST_BATCH / wall:.2f} images/s, the first epoch's start included), "
        f"max_gt {loader.max_gt}, losses " +
        ", ".join(f"{float(m['loss']):.4f}" for m in trainer.history) + f"; launches {launches}")
    return trainer, launches, wall


def _host_items_per_s(dataset, hyp, workers):
    """The host pipeline alone: one pass of a HOST_BATCH train loader over
    `dataset` with `workers` threads: items/s over the pass, and after the
    first batch (the pool's start taken out)."""
    loader = DataLoader(dataset, HOST_BATCH, IMGSZ, seed=0, train=True, hyp=hyp,
                        workers=workers)
    t0 = time.perf_counter()
    it = iter(loader)
    n = first = len(next(it)["img"])
    t1 = time.perf_counter()
    n += sum(len(b["img"]) for b in it)
    t2 = time.perf_counter()
    return {"items": n, "items_per_s": n / (t2 - t0),
            "items_per_s_after_first": (n - first) / (t2 - t1)}


def _host_card_vs_cpu(trainer):
    """The first host batch the trainer trained on (a fresh loader over a
    fresh dataset, so the same empty buffer and draws): its first HOST_HOLD
    images through one training step, float32 on the card against the
    model in float64 on the CPU, loss parts to PARTS_TOL and the DCN
    weight's gradient to GRAD_TOL. The float64 step is the reference
    because the float32 one on the CPU is not one on these images:
    letterbox and mosaic padding make the early BatchNorms' statistics
    cancel, and the CPU's float32 result moves with its thread count (on
    one thread the DCN weight's gradient 7.5% of its scale from the float64
    one on a batch like this, on eight 2.6e-4, measured on a CPU; on the
    card's host 8.2e-3, `PERF.md` section 6)."""
    from mgdt_yolo_tpu_torch.engine.trainer import build_loader
    batch = next(iter(build_loader(trainer.args, True, trainer.model)))
    batch = {k: np.ascontiguousarray(v[:HOST_HOLD]) for k, v in batch.items()}
    (pg, gg), (pc, gc) = (_float32_train_step(dev, batch, dtype=dt)
                          for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)))
    gaps = _grad_gaps(gg, gc)
    dcn = "model_16.DyDCNV2.weight"
    parts = ((pg - pc.float()).abs() / pc.float().abs()).tolist()
    ok = max(parts) <= PARTS_TOL and gaps[dcn] <= GRAD_TOL and gc[dcn].abs().max().item() > 0
    log(f"a step on {HOST_HOLD} images of the first host batch, card float32 vs CPU float64: "
        f"parts card {pg.tolist()} cpu {pc.tolist()} (relative {parts}); DCN weight gradient "
        f"gap {gaps[dcn]:.3e} {'ok' if ok else 'FAIL'}; the other gradients " +
        ", ".join(f"{n} {g:.3e}" for n, g in gaps.items() if n != dcn))
    if not ok:
        raise SystemExit("the card's float32 step on a host batch disagrees with the CPU's")
    return {"parts_card": pg.tolist(), "parts_cpu_float64": pc.tolist(), "grad_gaps": gaps}


def _loop_line(r):
    return (f"{r['images_per_s']:.2f} images/s over {r['images']} images in {r['batches']} "
            f"batches ({r['images_per_s_after_first']:.2f} with the wait for the first batch, "
            f"{r['first_batch_wait_s'] * 1e3:.1f} ms, taken out), loader wait "
            f"{r['loader_wait_share']:.1%} of the wall time ({r['loader_wait_share_after_first']:.1%}"
            f" after the first batch), device idle {r['device_idle_share']:.1%}")


def phase_host_augmentation(root):
    """The flagship trained through the host augmentation pipeline on phase
    15's dataset. Returns (launches, rows)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.engine.trainer import get_dataset
    from mgdt_yolo_tpu_torch.utils.tuner import SEARCH_SPACE
    log(f"== phase 18: host augmentation (device_augment=False, cv2's arithmetic in numpy, "
        f"its hot loops in C++) on "
        f"phase 15's dataset: MGDT-n, b{HOST_BATCH}, {IMGSZ} px, bf16, {HOST_STEPS} micro-steps "
        f"under the JAX defaults and {HOST_STEPS} with {HOST_ALL_ON}; card vs CPU; the "
        f"pipeline's items/s over the train split listed several times ("
        f"{', '.join(f'{w} threads {k}x' for w, k in HOST_THREADS.items())}) and the train "
        f"loop on the host and the device path over it {HOST_REPEATS}x; one tune trial from "
        f"JAX's default space")
    t_phase = time.perf_counter()
    t_lap = [t_phase]
    data = root / "pigs" / "data.yaml"
    runs = root / "host"
    total, rows = no_launches(), {"steps_s": {}}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def lap(step):
        """The seconds `step` took, on the host's clock, into rows."""
        now = time.perf_counter()
        rows["steps_s"][step] = now - t_lap[0]
        log(f"[phase 18: {step} took {now - t_lap[0]:.2f} s]")
        t_lap[0] = now

    tr, launches, wall = _host_train(_host_overrides(data, runs), runs / "defaults",
                                     "JAX defaults")
    add(launches)
    rows["defaults"] = {"train_wall_s": wall, "images_per_s": HOST_STEPS * HOST_BATCH / wall,
                        "max_gt": tr.loader.max_gt}
    all_on, launches, wall = _host_train(
        _host_overrides(data, runs, device_augment=True, **HOST_ALL_ON), runs / "all_on",
        "every host-only key (device_augment=True, fallen back)")
    add(launches)
    rows["all_on"] = {"train_wall_s": wall, "images_per_s": HOST_STEPS * HOST_BATCH / wall,
                      "max_gt": all_on.loader.max_gt}
    want_gt = int(math.ceil(all_on.loader.dataset.max_labels() * 10 / 8) * 8)
    if all_on.loader.max_gt != want_gt:
        raise SystemExit(f"max_gt {all_on.loader.max_gt} with mosaic9 and mixup, not {want_gt}")
    del all_on
    lap("train")
    rows["card_vs_cpu"] = _host_card_vs_cpu(tr)
    lap("card_vs_cpu")

    # the timed passes over the whole train split, listed several times
    split = get_dataset({**tr.args, "fraction": 1.0}, True, tr.model)
    rows["items_per_s_by_threads"] = {w: _host_items_per_s(_repeated(split, k), tr.args, w)
                                      for w, k in HOST_THREADS.items()}
    log("host pipeline by threads: " + "; ".join(
        f"{w}: {r['items_per_s']:.2f} items/s over {r['items']} items, "
        f"{r['items_per_s_after_first']:.2f} after the first batch"
        for w, r in rows["items_per_s_by_threads"].items()))
    lap("items_per_s")
    reset_counts()
    rows["train_loop"] = r = _disk_epoch(tr, HOST_REPEATS, dataset=split)
    launches = read_counts()
    add(launches)
    steps = r["batches"]
    _expect(launches, "the timed host loop", deform_fwd=steps, deform_bwd=steps)
    log(f"train b{HOST_BATCH} on the host path: {_loop_line(r)}")
    del tr
    lap("host_loop")
    # the device path at the same batch size, after the same two micro-steps
    # (not counted: it is the comparison, not the host path)
    dev = Trainer(DetectionModel.from_npz(WEIGHTS, device=DEVICE),
                  overrides=_host_overrides(data, runs, device_augment=True))
    if not dev.device_augment or dev.augment_fn is None:
        raise SystemExit("the comparison's trainer did not take the device path")
    dev.train()
    rows["device_loop"] = d = _disk_epoch(dev, HOST_REPEATS, dataset=split)
    log(f"train b{HOST_BATCH} on the device path from disk: {_loop_line(d)}; the host path "
        f"at {r['images_per_s'] / d['images_per_s']:.3f}x its images/s "
        f"({r['images_per_s_after_first'] / d['images_per_s_after_first']:.3f}x after the "
        f"first batch)")
    del dev, split
    torch.cuda.empty_cache()
    lap("device_loop")

    # one trial of JAX's default space through the facade
    yt = YOLO(str(WEIGHTS), device=DEVICE)
    reset_counts()
    t0 = time.perf_counter()
    best, fit, history = yt.tune(
        data=str(data), max_samples=1,
        train_args={k: v for k, v in _host_overrides(data, runs / "tune").items()
                    if k not in ("data", "val")})
    torch.cuda.synchronize()
    launches = read_counts()
    add(launches)
    tr = yt.trainer
    steps, n_val = len(tr.loader), len(tr.val_loader)
    drawn = {k: history[0][k] for k in ("degrees", "shear", "perspective", "mixup",
                                        "copy_paste")}
    _expect(launches, "the tune trial", deform_fwd=steps + n_val, deform_bwd=steps)
    _finite_history(tr, "the tune trial")
    if list(best) != list(SEARCH_SPACE) or not all(v > 0 for v in drawn.values()) or \
            tr.device_augment or not fit >= 0 or \
            not (runs / "tune" / "tune_0" / "results.csv").is_file():
        raise SystemExit(f"the tune trial did not train JAX's default space on the host: {best}")
    rows["tune"] = {"wall_s": time.perf_counter() - t0, "fitness": fit, "drawn": drawn}
    log(f"tune trial from JAX's default space (drawn {drawn}): {steps} micro-steps and "
        f"{n_val} validation forwards in {rows['tune']['wall_s']:.2f} s, fitness {fit:.5f}, "
        f"launches {launches}")
    lap("tune")
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {rows['phase_s']:.1f} s; launches {total}")
    return total, rows


# phase 19: the callback bus, its file loggers and the drawing
PLOT_BATCH = 16
PLOT_FILES = {"labels.jpg": (1200, 1200), "val_batch0_labels.jpg": None,
              "val_batch0_pred.jpg": None, "train_batch0.jpg": None,
              "confusion_matrix.png": (840, 960)}
TRAIN_HOOK_ORDER = ["on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
                    "on_train_epoch_start", "on_train_batch_end", "on_train_epoch_end",
                    "on_model_save", "on_fit_epoch_end", "on_train_end"]
# the predictor is timed over the val JPEGs listed this many times (links
# under other names), so b32 runs whole batches a window; 4 until PR 26, cut
# to 2 to pay for phase 26's MPEG-4 Part 2 and VP8 work
PREDICT_REPEATS = 2
PREDICT_BATCHES = (1, 32)


def _grid_hw(n, h, w):
    k = int(math.ceil(min(n, 16) ** 0.5))
    return k * h, k * w


def _libjpeg_q95(img, path):
    """libjpeg's own quality-95 4:2:0 file of a BGR (or grey) array, through
    PIL (the bytes cv2.imwrite writes, `tests/test_torch_plotting.py`):
    its size in bytes."""
    from PIL import Image
    Image.fromarray(img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])).save(
        path, quality=95, subsampling=2)
    return path.stat().st_size


def phase_plots(root):
    """The callback bus, the file loggers and the drawing on phase 15's
    dataset: `YOLO.train` with `plots=True`, every hook recorded, the MLflow
    store on; `.val()` in float32 and with `half=True`; `.predict(save=True,
    save_crop=True)` at b1 and b32 against the same without `save`, over the
    val JPEGs listed PREDICT_REPEATS times; every JPEG written read back by
    the card's decoder. Returns (launches, rows)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.engine import predictor as predictor_mod
    from mgdt_yolo_tpu_torch.utils import callbacks, draw
    log(f"== phase 19: the callback bus, its file loggers and the drawing on phase 15's "
        f"dataset: YOLO.train b{PLOT_BATCH} 1 epoch with plots=True, every hook recorded and "
        f"the MLflow store; val float32 and half=True; predict with save and save_crop at "
        f"{' and '.join(f'b{b}' for b in PREDICT_BATCHES)} over the val JPEGs listed "
        f"{PREDICT_REPEATS} times; every JPEG read back through the card's decoder")
    t_phase = time.perf_counter()
    data = root / "pigs" / "data.yaml"
    val_dir = root / "pigs" / "images" / "val"
    files = sorted(val_dir.iterdir())
    total, rows = no_launches(), {}

    def add(launches):
        for k in total:
            total[k] += launches[k]
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        rows["tensorboard"] = "imports"
    except ImportError as e:
        rows["tensorboard"] = f"does not import ({e})"
    log(f"torch.utils.tensorboard on this host: {rows['tensorboard']}")

    # every image the port writes: its path -> the digest of the array drawn,
    # each distinct array kept once
    written, arrays, imwrite = {}, {}, draw.imwrite

    def keep(path, img):
        img = np.ascontiguousarray(img)
        key = (hashlib.sha1(img.tobytes()).hexdigest(), img.shape)
        arrays.setdefault(key, img.copy())
        written[str(path)] = key
        return imwrite(path, img)
    hooks = []
    draw.imwrite = keep
    Trainer.init_callbacks = lambda self: (callbacks.CallbackMixin.init_callbacks(self), [
        self.add_callback(h, lambda t, h=h: hooks.append(h)) for h in callbacks.HOOKS])
    mlruns = root / "mlruns"
    os.environ["MGDT_MLFLOW_DIR"] = str(mlruns)
    try:
        y = YOLO(str(WEIGHTS), device=DEVICE)
        reset_counts()
        t0 = time.perf_counter()
        y.train(data=str(data), epochs=1, batch=PLOT_BATCH, optimizer="SGD", workers=8,
                project=str(root / "plots"), name="train", plots=True)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        del Trainer.init_callbacks
        os.environ.pop("MGDT_MLFLOW_DIR", None)
    add(launches)
    tr = y.trainer
    steps, n_val = len(tr.loader), len(tr.val_loader)
    _expect(launches, "the plots=True training", deform_fwd=steps + n_val, deform_bwd=steps)
    want_hooks = TRAIN_HOOK_ORDER[:4] + ["on_train_batch_end"] * steps + TRAIN_HOOK_ORDER[5:]
    if hooks != want_hooks:
        raise SystemExit(f"the trainer fired {hooks}, not JAX's {want_hooks}")
    if not tr.validator.args["half"] or not tr.amp:
        raise SystemExit("the in-training validation did not run under the trainer's bf16 amp")
    run = tr.save_dir
    events = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
    keys = ["t", "epoch", "box_loss", "cls_loss", "dfl_loss",
            *[k for k, v in tr.metrics.items() if isinstance(v, (int, float))]]
    if len(events) != 1 or list(events[0]) != keys:
        raise SystemExit(f"events.jsonl holds {events}, not one row of {keys}")
    exps = [p for p in mlruns.iterdir() if p.is_dir()]
    mruns = [p for p in exps[0].iterdir() if p.is_dir()] if len(exps) == 1 else []
    if len(mruns) != 1 or sorted(p.name for p in mruns[0].iterdir()) != \
            ["artifacts", "meta.yaml", "metrics", "params", "tags"] or \
            "status: 3" not in (mruns[0] / "meta.yaml").read_text() or \
            len(list((mruns[0] / "params").iterdir())) != len(CFG_DEFAULTS) or \
            not (mruns[0] / "artifacts" / "last.npz").is_file():
        raise SystemExit(f"the MLflow store under {mlruns} is not the file store's layout")
    sizes = {**PLOT_FILES,
             "train_batch0.jpg": _grid_hw(PLOT_BATCH, IMGSZ, IMGSZ),
             "val_batch0_labels.jpg": _grid_hw(PLOT_BATCH, IMGSZ, IMGSZ),
             "val_batch0_pred.jpg": _grid_hw(PLOT_BATCH, IMGSZ, IMGSZ)}
    for name, hw in sizes.items():
        got = native.decode(run / name).shape[:2]
        if got != hw:
            raise SystemExit(f"{name} is {got}, not {hw}")
    rows["train"] = {"wall_s": time.perf_counter() - t0, "plot_train_start_s": tr.plot_seconds,
                     "hooks": len(hooks), "launches": launches}
    log(f"YOLO.train with plots: {steps} micro-steps + {n_val} validation forwards in "
        f"{rows['train']['wall_s']:.2f} s, the train-start plots {tr.plot_seconds:.3f} s of it "
        f"(labels.jpg over {len(tr.loader.dataset)} items, train_batch0.jpg); hooks "
        f"{hooks}; events.jsonl {events[0]}; {sorted(sizes)} at their sizes; launches "
        f"{launches}")

    # the standalone validator's dtype: float32, and bf16 with half=True
    reset_counts()
    maps, preds = {}, {}
    for name, kw in (("float32", {}), ("bf16", {"half": True})):
        res = y.val(data=str(data), batch=PLOT_BATCH, plots=False, **kw)
        maps[name] = {k: res[k] for k in ("map50", "map")}
        preds[name] = y.validator.per_image_preds
    launches = read_counts()
    add(launches)
    if all(a.shape == b.shape and np.array_equal(a, b)
           for a, b in zip(preds["float32"], preds["bf16"])):
        raise SystemExit("val(half=True) gave the float32 run's detections")
    rows["val_dtype"] = maps
    log(f"standalone val mAP50-95: float32 {maps['float32']['map']:.6f}, half=True (bf16) "
        f"{maps['bf16']['map']:.6f}; mAP50 {maps['float32']['map50']:.6f} / "
        f"{maps['bf16']['map50']:.6f}; launches {launches}")

    # predict with and without save / save_crop, in turns, over the val JPEGs
    # listed PREDICT_REPEATS times
    src = root / "plots" / "predict_src"
    src.mkdir(parents=True)
    for k in range(PREDICT_REPEATS):
        for f in files:
            (src / f"{f.stem}_{k}{f.suffix}").symlink_to(f)
    n_src = PREDICT_REPEATS * len(files)
    spent = [0.0]
    save = predictor_mod.BasePredictor._save

    def timed_save(self, r, item=None):
        t = time.perf_counter()
        save(self, r, item)
        spent[0] += time.perf_counter() - t
    predictor_mod.BasePredictor._save = timed_save
    rows["predict"] = {}
    try:
        for b in PREDICT_BATCHES:
            for saving in (False, True, False, True):
                kw = {"save": True, "save_crop": True} if saving else {}
                out = root / "plots" / f"predict_b{b}"
                # a warm-up call over one file builds the facade's predictor,
                # then it is timed
                y.predict(str(files[0]), batch=b, project=str(root / "plots"),
                          name=f"predict_b{b}", **kw)
                reset_counts()
                spent[0] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = y.predictor(str(src), batch=b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = read_counts()
                add(launches)
                if len(res) != n_src or launches["deform_fwd"] != -(-n_src // b):
                    raise SystemExit(f"predict b{b} over {n_src} images gave {len(res)} results "
                                     f"in {launches['deform_fwd']} K1 launches")
                key = f"b{b}_{'save' if saving else 'plain'}"
                r = rows["predict"].setdefault(key, {"images": n_src, "batches": -(-n_src // b),
                                                     "images_per_s": [], "draw_share": []})
                r["images_per_s"].append(n_src / wall)
                r["draw_share"].append(spent[0] / wall)
                if saving:
                    for rr in res:
                        stem = Path(rr.path).stem
                        if not (out / f"{stem}.jpg").is_file():
                            raise SystemExit(f"predict(save=True) did not write {stem}.jpg")
                        for c in {int(v) for v in rr.boxes.cls}:
                            if not (out / "crops" / rr.names[c] / f"{stem}.jpg").is_file():
                                raise SystemExit(f"save_crop did not write crops of {c}")
    finally:
        predictor_mod.BasePredictor._save = save
        draw.imwrite = imwrite
    for key, r in rows["predict"].items():
        log(f"predict {key} over {n_src} images ({r['batches']} batches): images/s {', '.join(f'{v:.2f}' for v in r['images_per_s'])}; "
            f"drawing + encoding share of the wall time "
            f"{', '.join(f'{v:.4f}' for v in r['draw_share'])}")

    # every JPEG written, read back through the card's decoder and held as the
    # CPU tests hold cv2's reading (draw.jpeg_reading): within a mean of
    # JPEG_READ_MEAN grey levels of draw.jpeg_reference, and its PSNR at most
    # JPEG_READ_PSNR_DB below the card's reading of libjpeg's own q95 file of
    # the same array
    lib_path, per_key = root / "plots" / "libjpeg_q95.jpg", {}
    worst = {"mean_diff": 0.0, "max_diff": 0, "psnr_gap_db": -math.inf, "min_psnr_db": math.inf,
             "size_ratio": 0.0}
    n_jpeg = 0
    for path, key in written.items():
        if not path.endswith(".jpg"):
            continue
        img = arrays[key]
        if key not in per_key:
            lib_size = _libjpeg_q95(img, lib_path)
            per_key[key] = (native.decode(lib_path), draw.jpeg_reference(img), lib_size)
        lib_back, ref, lib_size = per_key[key]
        got = draw.jpeg_reading(native.decode(path), img, lib_back, ref)
        n_jpeg += 1
        worst = {"mean_diff": max(worst["mean_diff"], got["mean_diff"]),
                 "max_diff": max(worst["max_diff"], got["max_diff"]),
                 "psnr_gap_db": max(worst["psnr_gap_db"], got["psnr_gap_db"]),
                 "min_psnr_db": min(worst["min_psnr_db"], got["psnr_db"]),
                 "size_ratio": max(worst["size_ratio"], Path(path).stat().st_size / lib_size)}
        if not got["holds"]:
            raise SystemExit(f"{path}: the card reads it {got['mean_diff']:.4f} grey levels on "
                             f"average from the reference reading (limit {draw.JPEG_READ_MEAN}) "
                             f"at {got['psnr_db']:.3f} dB against libjpeg's q95 file's "
                             f"{got['libjpeg_psnr_db']:.3f} (at most {draw.JPEG_READ_PSNR_DB} "
                             f"below)")
    rows["jpeg_readback"] = {"files": n_jpeg, "arrays": len(per_key), **worst}
    log(f"{n_jpeg} JPEGs ({len(per_key)} distinct arrays) read back through the card's decoder: "
        f"on average at most {worst['mean_diff']:.4f} grey levels from the reference reading "
        f"(limit {draw.JPEG_READ_MEAN}; single pixels up to {worst['max_diff']}); PSNR at most "
        f"{worst['psnr_gap_db']:.4f} dB below the card's reading of libjpeg's q95 file (limit "
        f"{draw.JPEG_READ_PSNR_DB}), the least {worst['min_psnr_db']:.2f} dB; at most "
        f"{worst['size_ratio']:.4f}x libjpeg's size")
    rows["launches"] = total
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {rows['phase_s']:.1f} s; launches {total}")
    log(f"phase 19 rows: {json.dumps(rows, default=float)}")
    return total, rows


# phase 20: YOLOv8's segment and pose models at n-scale, from the port's
# seeded init (no such weights are in the repository), by their YAML names;
# nc 2 for segment, the pose YAML's own 1
SEG_POSE = {"yolov8n-seg.yaml": 2, "yolov8n-pose.yaml": 1}
SEG_POSE_TRAIN, SEG_POSE_SCENES, SEG_POSE_BATCHES = 16, 32, (1, 32)
# the timed training loop's steps (after the trainer's one functional
# epoch) and those of the same step on one resident batch; how many times
# the predictor's window lists the scenes at each batch: b1 32 requests,
# b32 2 full batches; a b32 window that keeps no detection runs again at
# the validator's conf, so that NMS has rows to sort
SEG_POSE_STEPS, SEG_POSE_RESIDENT = 6, 8
SEG_POSE_REPEATS, SEG_POSE_LOW_CONF = {1: 1, 32: 2}, 0.001


def _aux_arrays(aux):
    """The aux output's arrays in order: the raw maps, then the coefficients
    and prototypes, or the raw keypoints."""
    maps, *rest = aux
    return [*maps, *rest]


def _seg_pose_card_vs_cpu(name, nc):
    """A float32 fused forward of two noise images on the card and on the
    CPU (plain ops), from `_calibrated_state`: every raw map and aux array
    (coefficients and prototypes, or raw keypoints) within phase 8's 1e-2 of
    its magnitude (at least 1), the decoded boxes within 0.5 px and the
    other decoded channels (class scores, then the coefficients or the
    keypoints in pixels) within 1e-3 of their magnitude (at least 1); then
    the predictor's NMS (no class count, so every channel after the box is
    a class score, as JAX's) on the card and on the CPU given the same
    decoded tensor (the CPU's) at a threshold that passes ~1000 anchors:
    the same counts (some detections), boxes and scores within 1e-4; NMS
    on each device's own output is logged, as phase 13 logs it. Returns the
    differences."""
    x = torch.rand((2, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(20))
    state, outs = _calibrated_state(name, nc), []
    for dev in (DEVICE, "cpu"):
        model = DetectionModel(name, nc=nc, device=dev)
        model.load_state_dict(state)
        model.fuse()
        with torch.no_grad(), float32_exact():
            decoded, aux = model(x.to(dev))
        outs.append(([a.cpu() for a in _aux_arrays(aux)], decoded.cpu()))
    (ag, dg), (ac, dc) = outs
    raw_err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                  for a, b in zip(ag, ac))
    box_err = (dg[:, :4] - dc[:, :4]).abs().max().item()
    rest_err = (dg[:, 4:] - dc[:, 4:]).abs().max().item() / max(1.0, dc[:, 4:].abs().max().item())
    ranked = dc[:, 4:].amax(1).flatten().sort(descending=True).values
    thr = float(ranked[min(999, len(ranked) - 1)])
    kw = dict(conf_thres=thr, iou_thres=predictor.IOU, max_det=predictor.MAX_DET,
              pre_topk=predictor.PRE_TOPK, block=predictor.BLOCK)
    (det_g, cnt_g), (det_c, cnt_c) = ((t.cpu() for t in non_max_suppression(dc.to(dev), **kw))
                                      for dev in (DEVICE, "cpu"))
    same = torch.equal(cnt_g, cnt_c) and int(cnt_c.sum()) > 0
    nms_err = (det_g - det_c).abs().max().item() if same else None
    past_nc = int((det_c[..., 5] >= nc).sum())
    own_g = non_max_suppression(dg.to(DEVICE), **kw)[1].cpu()
    ok = raw_err <= 1e-2 and box_err < 0.5 and rest_err <= 1e-3 and same and nms_err <= 1e-4
    log(f"{name} float32 card vs CPU: raw maps and aux max |diff| / max(1, max |x|) "
        f"{raw_err:.3e} (limit 1e-2), decoded boxes {box_err:.3e} px, other channels "
        f"{rest_err:.3e} of their magnitude; NMS at conf {thr:.6f} on the same decoded tensor: "
        f"kept card {cnt_g.tolist()} cpu {cnt_c.tolist()} ({past_nc} rows of a class past nc, "
        f"the reference's ranking of the extra channels), max |diff| {nms_err}; on each "
        f"device's own output: card {own_g.tolist()} (logged) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the card and the CPU disagree")
    return {"raw_max_rel_diff": raw_err, "box_max_abs_diff": box_err,
            "channels_max_rel_diff": rest_err, "nms_kept": int(cnt_c.sum()),
            "nms_max_abs_diff": nms_err, "rows_past_nc": past_nc}


class _KeepFirst:
    """A loader that keeps the first batch it yields (`first`)."""

    def __init__(self, loader):
        self.loader, self.first = loader, None

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            if self.first is None:
                self.first = batch
            yield batch


def _timed_train(name, nc, root):
    """`YOLO(name).train` on the synthetic scenes of its task at IMGSZ (64
    scenes, b SEG_POSE_TRAIN, bf16 autocast, the host pipeline with masks or
    keypoints; one epoch, then the validation on 16 scenes), the epoch's
    four steps timed by the trainer's hooks; then the trainer's timed loop
    (`_timed_train_loop`) over SEG_POSE_STEPS batches of fresh scenes of the
    task through the same pipeline: images/s with and without the first
    batch, the loader's wait share and the device's idle share; then the
    same step SEG_POSE_RESIDENT times on that loop's first batch, with no
    loader threads running (not profiled). Returns (facade, launches,
    row)."""
    from mgdt_yolo_tpu_torch import YOLO
    marks = {}
    init = Trainer.init_callbacks

    def timed_init(self):
        init(self)
        for hook in ("on_train_epoch_start", "on_train_epoch_end", "on_fit_epoch_end"):
            self.add_callback(hook, lambda t, hook=hook: (torch.cuda.synchronize(),
                                                          marks.__setitem__(hook,
                                                                            time.perf_counter())))
    # the seeded init at `nc` classes, as an npz the facade loads (its name
    # gives the task, as JAX's facade reads it)
    from mgdt_yolo_tpu_torch.engine.exporter import metadata
    from mgdt_yolo_tpu_torch.weights import save_npz
    seeded = DetectionModel(name, nc=nc, device="cpu")
    npz = save_npz(seeded, root / "seg_pose_init" / f"{Path(name).stem}.npz",
                   metadata(seeded, IMGSZ))
    y = YOLO(str(npz), device=DEVICE)
    if (y.model.nc, y.task, y.model.task) != (nc, seeded.task, seeded.task):
        raise SystemExit(f"{name}: YOLO(npz) gave nc {y.model.nc}, task {y.task}")
    Trainer.init_callbacks = timed_init
    try:
        reset_counts()
        t0 = time.perf_counter()
        metrics = y.train(epochs=1, batch=SEG_POSE_TRAIN, imgsz=IMGSZ, optimizer="SGD",
                          workers=8, project=str(root / "seg_pose"), name=name, **NO_PLOTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        Trainer.init_callbacks = init
    tr = y.trainer
    _finite_history(tr, f"{name} training")
    extra = "mask" if y.task == "segment" else "kpt"
    if tr.amp != (DEVICE == "cuda") or \
            not {"box_map50", f"{extra}_map50", "fitness"} <= set(metrics) or \
            not all(math.isfinite(v) for v in metrics.values()):
        raise SystemExit(f"{name}: the training's validation gave {metrics} (amp {tr.amp})")
    n = len(tr.loader) * SEG_POSE_TRAIN
    loop = marks["on_train_epoch_end"] - marks["on_train_epoch_start"]
    row = {"steps": len(tr.loader), "images": n, "epoch_images_per_s": n / loop,
           "epoch_loop_s": loop, "val_s": marks["on_fit_epoch_end"] - marks["on_train_epoch_end"],
           "wall_s": wall, "criterion": type(tr.criterion).__name__,
           "val": {k: float(v) for k, v in metrics.items()}}
    planes = "masks" if y.task == "segment" else "keypoints"
    log(f"{name} YOLO.train b{SEG_POSE_TRAIN} bf16, 1 epoch of {n} synthetic scenes at {IMGSZ} "
        f"px with their {planes}: {row['epoch_images_per_s']:.2f} images/s over its "
        f"{row['steps']} steps ({loop:.3f} s, the first batch's cold start included), "
        f"validation {row['val_s']:.3f} s, wall {wall:.3f} s; box mAP50 "
        f"{metrics['box_map50']:.4f}, {extra} mAP50 {metrics[f'{extra}_map50']:.4f}; "
        f"launches {launches}")
    ds = SyntheticDetectionDataset(n=SEG_POSE_STEPS * SEG_POSE_TRAIN, imgsz=IMGSZ, nc=nc,
                                   seed=1, task=y.task)
    loader = DataLoader(ds, SEG_POSE_TRAIN, IMGSZ, seed=0, train=True,
                        device_augment=tr.device_augment, hyp=tr.args,
                        workers=tr.args["workers"])
    if tr.device_augment or not loader.host_augment:
        raise SystemExit(f"{name}: the timed loop did not take the host pipeline")
    keep = _KeepFirst(loader)
    reset_counts()
    t0 = time.perf_counter()
    row["loop"] = r = _timed_train_loop(tr, keep)
    # the loop's call in all: its wall, then the profiler's event processing
    row["loop_call_s"] = time.perf_counter() - t0
    row["resident"] = q = _timed_train_loop(tr, [keep.first] * SEG_POSE_RESIDENT,
                                            profile=False)
    loop_launches = read_counts()
    if r["batches"] != SEG_POSE_STEPS or not all(bool(torch.isfinite(p).all())
                                                 for p in tr.model.parameters()):
        raise SystemExit(f"{name}: the timed loop ran {r['batches']} steps, or left "
                         "non-finite weights")
    log(f"{name} train b{SEG_POSE_TRAIN} bf16 on the host path with its {planes}: "
        f"{_loop_line(r)} (the call {row['loop_call_s']:.2f} s with the profiler's "
        f"processing); the same step on its first batch, resident, "
        f"{SEG_POSE_RESIDENT} times: {q['images_per_s']:.2f} images/s; launches "
        f"{loop_launches}")
    return y, [launches, loop_launches], row


def _timed_seg_pose_predict(y, scenes, batch, repeats, **kw):
    """The predictor (fused, bf16; `kw` its other settings) at `batch` once
    over a batch of `scenes` (at b1 one scene of each size) to warm up, then
    timed over `scenes` listed `repeats` times: images/s, the detections
    kept, and the launches."""
    p = _entry_predictor(copy.deepcopy(y.model), DEVICE, half=True, **kw)
    p(scenes[:max(batch, len(SCENE_SIZES))], batch=batch)
    window = scenes * repeats
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = p(window, batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if len(results) != len(window) or not all(np.isfinite(r.boxes.data).all() for r in results):
        raise SystemExit("the segment/pose predictor gave malformed or non-finite results")
    return launches, {"images": len(window), "images_per_s": len(window) / wall,
                      "wall_s": wall, "detections": sum(len(r) for r in results)}


def phase_seg_pose(root):
    """YOLOv8's segment and pose models (n-scale, 640 px, seeded init): the
    float32 forward card vs CPU, `YOLO(...).train` (bf16, b16, one epoch of
    the synthetic scenes with their masks or keypoints, with validation)
    and a timed loop of SEG_POSE_STEPS steps, `val` (float32), `predict` at
    b1 and b32 (fused, bf16) over the scenes listed SEG_POSE_REPEATS times
    (b32 again at conf SEG_POSE_LOW_CONF if it kept no detection), and npz export and reload
    (`YOLO(npz)`, `AutoBackend`) held bit for bit to the live model. No
    hand kernel is on this path (the `Detect`-based heads run no DCN, and
    the segment and pose trainers augment on the host): every count must
    stay 0. Returns (launches, rows)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.nn.autobackend import AutoBackend
    log(f"== phase 20: segment and pose ({', '.join(SEG_POSE)}, {IMGSZ} px, seeded init): "
        f"float32 card vs CPU, YOLO.train b{SEG_POSE_TRAIN} bf16 with validation, then "
        f"{SEG_POSE_STEPS} timed steps and {SEG_POSE_RESIDENT} on a resident batch, val, "
        f"predict over {SEG_POSE_SCENES} scenes listed "
        f"{' and '.join(f'{k}x at b{b}' for b, k in SEG_POSE_REPEATS.items())}, npz export "
        f"and reload")
    t_phase = time.perf_counter()
    total, rows = no_launches(), {}
    scenes = _scenes(SEG_POSE_SCENES)
    for name, nc in SEG_POSE.items():
        t_lap = [time.perf_counter()]
        row = {"steps_s": {}}

        def lap(step):
            """The seconds `step` took, on the host's clock, into the row."""
            now = time.perf_counter()
            row["steps_s"][step] = now - t_lap[0]
            t_lap[0] = now

        row["card_vs_cpu"] = _seg_pose_card_vs_cpu(name, nc)
        lap("card_vs_cpu")
        y, runs, row["train"] = _timed_train(name, nc, root)
        lap("train_and_loops")
        reset_counts()
        t0 = time.perf_counter()
        val = y.val(batch=SEG_POSE_TRAIN, imgsz=IMGSZ)
        torch.cuda.synchronize()
        row["val_s"] = time.perf_counter() - t0
        runs.append(read_counts())
        if set(val) != set(row["train"]["val"]):
            raise SystemExit(f"{name}: val gave {sorted(val)}")
        row["val"] = {k: float(v) for k, v in val.items()}
        lap("val")
        for b in SEG_POSE_BATCHES:
            launches, row[f"predict_b{b}"] = _timed_seg_pose_predict(
                y, scenes, b, SEG_POSE_REPEATS[b])
            runs.append(launches)
            lap(f"predict_b{b}")
        b = max(SEG_POSE_BATCHES)
        if not row[f"predict_b{b}"]["detections"]:
            launches, row[f"predict_b{b}_conf{SEG_POSE_LOW_CONF}"] = _timed_seg_pose_predict(
                y, scenes, b, SEG_POSE_REPEATS[b], conf=SEG_POSE_LOW_CONF)
            runs.append(launches)
            lap(f"predict_b{b}_conf{SEG_POSE_LOW_CONF}")
        path = y.export(format="npz", imgsz=IMGSZ, project=str(root / "seg_pose_export"))[0]
        meta = json.loads(Path(path).with_name(Path(path).stem + "_metadata.json").read_text())
        x = torch.rand((2, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(21))
        reset_counts()
        with torch.no_grad(), float32_exact():
            live = y.model.eval()(x.to(DEVICE))[0]
            back = AutoBackend(path, imgsz=IMGSZ, device=DEVICE).forward(x)
            again = YOLO(path, device=DEVICE)
            reloaded = again.model(x.to(DEVICE))[0]
        torch.cuda.synchronize()
        runs.append(read_counts())
        if meta["task"] != y.task or again.task != y.task or not torch.equal(back, live) or \
                not torch.equal(reloaded, live):
            raise SystemExit(f"{name}: the npz export did not reload bit for bit "
                             f"(task {meta['task']} / {again.task})")
        row["export_npz"] = {"task": meta["task"], "decoded": list(live.shape)}
        lap("export_npz")
        for launches in runs:
            for k in total:
                total[k] += launches[k]
        _expect(total, f"{name}'s segment/pose path")
        rates = ", ".join(f"{key[len('predict_'):]} {r['images_per_s']:.2f} images/s over "
                          f"{r['images']} ({r['detections']} detections)"
                          for key, r in row.items() if key.startswith("predict_"))
        log(f"{name}: val (float32) {row['val_s']:.3f} s, box mAP50 {val['box_map50']:.4f}; "
            f"predict {rates}; npz export and reload bit for bit, decoded "
            f"{row['export_npz']['decoded']}; seconds by step: " +
            ", ".join(f"{k} {v:.2f}" for k, v in row["steps_s"].items()))
        rows[name] = row
        del y
        torch.cuda.empty_cache()
    rows["launches"] = total
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20: {rows['phase_s']:.1f} s; launches {total}")
    log(f"phase 20 rows: {json.dumps(rows, default=float)}")
    return total, rows


# phase 21: the rest of the zoo at its published widths (scale n where the
# YAML has scales; the v3s at their only width) and default nc, and YOLOv8's
# classifier at its published nc 1000 and 224 px, the size the reference
# trains classify at
ZOO_MODELS = ("yolov3.yaml", "yolov3-spp.yaml", "yolov3-tiny.yaml", "yolov5n.yaml",
              "yolov5n-p6.yaml", "yolov6n.yaml", "yolov8n-p2.yaml", "yolov8n-p6.yaml",
              "yolov8n-pose-p6.yaml")
ZOO_RATE, ZOO_TRAIN, ZOO_STEPS = 32, 16, 2
ZOO_OVERRIDES = {**TRAIN_OVERRIDES, "batch": ZOO_TRAIN, "nbs": 32}
CLS_IMGSZ, CLS_TRAIN, CLS_RESIDENT, CLS_RATE_BATCH = 224, 16, 16, 64
CLS_PROBS_TOL = 1e-4


def _zoo_card_vs_cpu(name, nc):
    """A float32 fused forward of two noise images on the card and on the
    CPU from `_calibrated_state`, at phase 13's limits: every raw map (and
    the pose head's raw keypoints) within ABLATION_RAW_TOL of its magnitude
    (at least 1), decoded boxes within 0.5 px, the other decoded channels
    (scores, the keypoints in pixels) within 1e-3 of their magnitude (at
    least 1); NMS on the card and on the CPU given the same decoded tensor
    (the CPU's) at a threshold that passes ~1000 anchors (all those tied at
    the 1000th score where the scores saturate): the same counts, boxes and
    scores within 1e-4. Returns (the card's fused model, the differences)."""
    x = torch.rand((2, IMGSZ, IMGSZ, 3), generator=torch.Generator().manual_seed(22))
    state, outs, models = _calibrated_state(name, nc), [], []
    for dev in (DEVICE, "cpu"):
        model = DetectionModel(name, nc=nc, device=dev)
        model.load_state_dict(state)
        model.fuse()
        with torch.no_grad(), float32_exact():
            decoded, aux = model(x.to(dev))
        arrays = _aux_arrays(aux) if isinstance(aux, tuple) else aux
        outs.append(([a.cpu() for a in arrays], decoded.cpu()))
        models.append(model)
    (ag, dg), (ac, dc) = outs
    raw_err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                  for a, b in zip(ag, ac))
    box_err = (dg[:, :4] - dc[:, :4]).abs().max().item()
    rest_err = (dg[:, 4:] - dc[:, 4:]).abs().max().item() / max(1.0, dc[:, 4:].abs().max().item())
    ranked = dc[:, 4:].amax(1).flatten().sort(descending=True).values
    thr = ranked[min(999, len(ranked) - 1)]
    if not bool((ranked > thr).any()):  # saturated scores (v3's reach 1.0): pass the ties
        thr = torch.nextafter(thr, torch.tensor(float("-inf")))
    thr = float(thr)
    kw = dict(conf_thres=thr, iou_thres=predictor.IOU, max_det=predictor.MAX_DET,
              pre_topk=predictor.PRE_TOPK, block=predictor.BLOCK)
    (det_g, cnt_g), (det_c, cnt_c) = ((t.cpu() for t in non_max_suppression(dc.to(dev), **kw))
                                      for dev in (DEVICE, "cpu"))
    same = torch.equal(cnt_g, cnt_c) and int(cnt_c.sum()) > 0
    nms_err = (det_g - det_c).abs().max().item() if same else None
    ok = raw_err <= ABLATION_RAW_TOL and box_err < 0.5 and rest_err <= 1e-3 and same and \
        nms_err <= 1e-4
    log(f"{name} float32 card vs CPU: raw maps max |diff| / max(1, max |raw|) {raw_err:.3e} "
        f"(limit {ABLATION_RAW_TOL:.0e}), decoded boxes {box_err:.3e} px, other channels "
        f"{rest_err:.3e} of their magnitude; NMS at conf {thr:.6f} on the same decoded "
        f"tensor: kept card {cnt_g.tolist()} cpu {cnt_c.tolist()}, max |diff| {nms_err} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the card and the CPU disagree")
    return models[0], {"raw_max_rel_diff": raw_err, "box_max_abs_diff": box_err,
                       "channels_max_rel_diff": rest_err, "nms_kept": int(cnt_c.sum()),
                       "nms_max_abs_diff": nms_err}


def _zoo_model(name):
    """One zoo model: card vs CPU, then that fused model in bf16: a counted
    `predict` and images/s at ZOO_RATE (CUDA events, min over 3 windows);
    then ZOO_STEPS unaugmented micro-steps at ZOO_TRAIN through
    `Trainer.train()` (bf16 autocast). Returns (launches, row)."""
    t0 = time.perf_counter()
    cfg = load_config(name)
    nc = cfg["nc"]
    model, diffs = _zoo_card_vs_cpu(name, nc)
    row = {"stride": list(model.stride), "nc": nc, "task": model.task, "card_vs_cpu": diffs}
    model.to(torch.bfloat16)
    x = torch.from_numpy(synthetic_batch(ZOO_RATE, IMGSZ)).to(DEVICE)
    reset_counts()
    det, counts = predict(model, x)
    torch.cuda.synchronize()
    served = read_counts()
    if det.shape != (ZOO_RATE, 300, 6) or not bool(torch.isfinite(det).all()):
        raise SystemExit(f"{name}: serving gave malformed or non-finite detections")
    ms = cuda_time_ms(lambda: predict(model, x), iters=3, windows=3)
    row.update(fused=model.n_fused, rate_ms=ms, images_per_s=ZOO_RATE / ms * 1e3,
               detections=int(counts.sum()))
    del model
    model = DetectionModel(name, device=DEVICE)
    row["parameters"] = sum(p.numel() for p in model.parameters())
    ds = SyntheticDetectionDataset(n=ZOO_TRAIN * ZOO_STEPS, imgsz=IMGSZ, nc=nc, seed=0,
                                   task=model.task)
    trainer = Trainer(model, DataLoader(ds, ZOO_TRAIN, IMGSZ), overrides=ZOO_OVERRIDES)
    reset_counts()
    trainer.train()
    torch.cuda.synchronize()
    trained = read_counts()
    _finite_history(trainer, f"{name} training")
    if len(trainer.history) != ZOO_STEPS or not trainer.amp:
        raise SystemExit(f"{name}: {len(trainer.history)} micro-steps, amp {trainer.amp}")
    row["losses"] = [float(m["loss"]) for m in trainer.history]
    row["seconds"] = time.perf_counter() - t0
    log(f"{name}: strides {row['stride']}, {row['parameters']:,} parameters, nc {nc}; "
        f"{row['fused']} Conv+BN pairs fused; bf16 b{ZOO_RATE} {ms:.3f} ms, "
        f"{row['images_per_s']:.2f} images/s; train b{ZOO_TRAIN} losses "
        f"{', '.join(f'{v:.4f}' for v in row['losses'])}; {row['seconds']:.1f} s")
    del trainer, model
    torch.cuda.empty_cache()
    return [served, trained], row


def _classify(root):
    """`YOLO("yolov8n-cls.yaml")` (nc 1000) at CLS_IMGSZ: `train` for 1 epoch
    of the synthetic split (64 images, b CLS_TRAIN, float32 with TF32 off,
    validation on the held-out split), `val`; train images/s over
    CLS_RESIDENT steps of one resident b CLS_RATE_BATCH batch (CUDA events);
    the predictor over phase 15's val JPEGs at b1 on the card and on the
    CPU (top-1 equal, probabilities within CLS_PROBS_TOL; the dataset is
    written here where phase 15 did not run); npz export and
    `AutoBackend(npz)` bit for bit the live float32 forward. Returns
    (launches, row)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.engine.classify import (ClassificationDataset,
                                                     ClassificationPredictor, no_tf32)
    from mgdt_yolo_tpu_torch.nn.autobackend import AutoBackend
    runs, row, t0 = [], {}, time.perf_counter()
    y = YOLO("yolov8n-cls.yaml", device=DEVICE)
    reset_counts()
    t = time.perf_counter()
    res = y.train(data="synthetic", epochs=1, imgsz=CLS_IMGSZ, batch=CLS_TRAIN,
                  project=str(root / "classify"), name="train")
    torch.cuda.synchronize()
    row["train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    val = y.val(data="synthetic", imgsz=CLS_IMGSZ, batch=CLS_TRAIN)
    torch.cuda.synchronize()
    row["val_s"] = time.perf_counter() - t
    runs.append(read_counts())
    tr = y.trainer
    losses = [float(v) for v in tr.losses]
    if set(res) != {"top1", "top5", "best_top1"} or set(val) != {"top1", "top5"} or \
            len(losses) != 64 // CLS_TRAIN or not all(math.isfinite(v) for v in losses) or \
            not (root / "classify" / "train" / "weights" / "best.npz").is_file():
        raise SystemExit(f"classify: train gave {res}, val {val}, losses {losses}")
    row.update(train=res, val=val, losses=losses)
    batch = next(ClassificationDataset(None, imgsz=CLS_IMGSZ, nc=y.model.nc,
                                       n_synth=CLS_RATE_BATCH).batches(CLS_RATE_BATCH))
    img = torch.from_numpy(batch["img"]).to(DEVICE)
    label = torch.from_numpy(batch["label"]).long().to(DEVICE)
    with no_tf32():
        ms = cuda_time_ms(lambda: tr.train_step(img, label), iters=CLS_RESIDENT, windows=1)
    row["train_step_ms"] = ms
    row["train_images_per_s"] = CLS_RATE_BATCH / ms * 1e3
    val_dir = root / "pigs" / "images" / "val"
    if not val_dir.is_dir():  # the phase run alone
        _write_disk_dataset(root / "pigs")
    reset_counts()
    got = ClassificationPredictor({"imgsz": CLS_IMGSZ}).setup_model(
        copy.deepcopy(y.model))(str(val_dir))
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = ClassificationPredictor({"imgsz": CLS_IMGSZ}).setup_model(
        copy.deepcopy(y.model))(str(val_dir))
    torch.cuda.synchronize()
    row["predict_b1_images_per_s"] = len(got) / (time.perf_counter() - t)
    runs.append(read_counts())
    want = ClassificationPredictor({"imgsz": CLS_IMGSZ, "device": "cpu"}).setup_model(
        copy.deepcopy(y.model).cpu())(str(val_dir))
    err = max(float(np.abs(g.probs.data - w.probs.data).max()) for g, w in zip(got, want))
    same_top1 = [g.probs.top1 for g in got] == [w.probs.top1 for w in want]
    row["predict_card_vs_cpu"] = {"images": len(got), "top1_equal": same_top1,
                                  "probs_max_abs_diff": err}
    if len(got) != len(want) or not got or not same_top1 or err > CLS_PROBS_TOL:
        raise SystemExit(f"classify: the card's predictions and the CPU's disagree "
                         f"(top-1 equal {same_top1}, probs {err:.3e})")
    path = y.export(format="npz", imgsz=CLS_IMGSZ, project=str(root / "classify_export"))[0]
    x = torch.rand((2, CLS_IMGSZ, CLS_IMGSZ, 3), generator=torch.Generator().manual_seed(23))
    reset_counts()
    with torch.no_grad(), float32_exact():
        live = y.model.eval()(x.to(DEVICE))
        back = AutoBackend(path, imgsz=CLS_IMGSZ, device=DEVICE).forward(x)
    torch.cuda.synchronize()
    runs.append(read_counts())
    if back.shape != (2, 1000) or not torch.equal(back, live):
        raise SystemExit("classify: AutoBackend(npz) is not the live forward bit for bit")
    row["export_npz"] = {"probs": list(live.shape), "bit_for_bit": True}
    row["seconds"] = time.perf_counter() - t0
    log(f"yolov8n-cls (nc 1000, {CLS_IMGSZ} px, float32): train 1 epoch b{CLS_TRAIN} "
        f"{row['train_s']:.2f} s, losses {', '.join(f'{v:.4f}' for v in losses)}, top1 "
        f"{res['top1']:.3f} top5 {res['top5']:.3f}; val {row['val_s']:.2f} s; train "
        f"b{CLS_RATE_BATCH} resident {ms:.3f} ms a step, {row['train_images_per_s']:.2f} "
        f"images/s; predict b1 over {len(got)} JPEGs {row['predict_b1_images_per_s']:.2f} "
        f"images/s, card vs CPU top-1 equal, probs max |diff| {err:.3e} (limit "
        f"{CLS_PROBS_TOL:.0e}); npz + AutoBackend bit for bit; {row['seconds']:.1f} s")
    return runs, row


def phase_classify_and_zoo(root):
    """The rest of the zoo (`ZOO_MODELS`) and the classify task: see the
    module's text. No hand kernel is on this path: every count must stay 0.
    Returns (launches, rows)."""
    log(f"== phase 21: classify and zoo: {len(ZOO_MODELS)} zoo models at {IMGSZ} px (float32 "
        f"card vs CPU, bf16 b{ZOO_RATE} images/s, {ZOO_STEPS} b{ZOO_TRAIN} micro-steps), "
        f"yolov8n-cls at {CLS_IMGSZ} px (train, val, resident steps, predict card vs CPU, "
        f"npz + AutoBackend)")
    t_phase = time.perf_counter()
    total, rows = no_launches(), {}
    for name in ZOO_MODELS:
        runs, rows[name] = _zoo_model(name)
        for launches in runs:
            for k in total:
                total[k] += launches[k]
        _expect(total, f"{name}'s zoo path")
    runs, rows["yolov8n-cls.yaml"] = _classify(root)
    for launches in runs:
        for k in total:
            total[k] += launches[k]
    _expect(total, "the classify path")
    rows["launches"] = total
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 21: {rows['phase_s']:.1f} s; launches {total}")
    log(f"phase 21 rows: {json.dumps(rows, default=float)}")
    return total, rows


@contextlib.contextmanager
def _instrumented_tracking():
    """While open, every tracker update the predictor runs (its tracking
    callback, all of a batch's frames) and every GMC `apply` is timed on
    the host's clock, and each H kept: {"update": [(ms, frames)], "gmc_ms":
    [...], "H": [...]}. The callback is wrapped where `register_tracker`
    looks it up, the GMC at its class, so `YOLO.track` runs as a user's."""
    from mgdt_yolo_tpu_torch.tracker import gmc, track as track_mod
    rec = {"update": [], "gmc_ms": [], "H": []}
    callback, apply = track_mod.on_predict_postprocess_end, gmc.GMC.apply

    def timed_callback(pred):
        t0 = time.perf_counter()
        callback(pred)
        rec["update"].append(((time.perf_counter() - t0) * 1e3, len(pred.results)))

    def timed_apply(self, img):
        t0 = time.perf_counter()
        H = apply(self, img)
        rec["gmc_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["H"].append(H)
        return H

    track_mod.on_predict_postprocess_end, gmc.GMC.apply = timed_callback, timed_apply
    try:
        yield rec
    finally:
        track_mod.on_predict_postprocess_end, gmc.GMC.apply = callback, apply


def _tracker_yamls(root):
    """The trackers of the phase: the bundled ByteTrack and BoT-SORT YAMLs,
    and BoT-SORT's with `gmc_method: ecc`, `orb` and `sift` written under
    `root`."""
    from mgdt_yolo_tpu_torch.tracker.track import check_tracker_yaml
    yamls = {"bytetrack": "bytetrack.yaml", "botsort": "botsort.yaml"}
    for method in ("ecc", "orb", "sift"):
        path = root / f"botsort_{method}.yaml"
        path.write_text(check_tracker_yaml("botsort.yaml").read_text().replace(
            "gmc_method: sparseOptFlow", f"gmc_method: {method}"))
        yamls[f"botsort_{method}"] = str(path)
    return yamls


def _sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _gmc_against_cv2(frames):
    """The port's `orb` and `sift` GMC over the pan's first frames on this
    host against cv2's answer on the CPU (`PAN_H`): the frames by digest,
    ORB's keypoints and descriptors of frames 0 and 1 by digest, every H
    within TRACK_FEATURE_H, SIFT's else within TRACK_SIFT_PX and
    TRACK_SIFT_LINEAR (a frame whose match list is not cv2's). Returns
    {method: row}; ends the script on a disagreement."""
    from mgdt_yolo_tpu_torch.tracker import gmc
    fx = json.loads(PAN_H.read_text())
    n = fx["frames"]
    if fx["sequence"] != {"n": TRACK_FRAMES, "shape": list(TRACK_SHAPE), "seed": 7} or \
            [_sha256(f) for f in frames[:n]] != fx["frame_sha256"]:
        raise SystemExit(f"the pan's frames are not those of {PAN_H.name}")
    prep = gmc.GMC("orb")._prep
    for want in fx["orb"]:
        kps, desc = gmc.orb_features(prep(frames[want["frame"]]))
        got = {"keypoints": len(kps), "keypoints_sha256": _sha256(kps),
               "descriptors_sha256": _sha256(desc)}
        if any(got[k] != want[k] for k in got):
            raise SystemExit(f"ORB on frame {want['frame']}: {got} against cv2's {want}")
    log(f"GMC against cv2 ({PAN_H.name}, cv2 {fx['cv2']} on the CPU): {n} frames by digest; "
        f"ORB's {', '.join(str(w['keypoints']) for w in fx['orb'])} keypoints and descriptors "
        f"of frames {', '.join(str(w['frame']) for w in fx['orb'])} equal by SHA-256")
    out = {}
    for method in ("orb", "sift"):
        est, ms, hs = gmc.GMC(method), [], []
        for f in frames[:n]:
            t0 = time.perf_counter()
            hs.append(est.apply(f))
            ms.append((time.perf_counter() - t0) * 1e3)
        got, want = np.stack(hs), np.asarray(fx["H"][method])
        dt = np.abs(got[:, :, 2] - want[:, :, 2]).max(1)
        da = np.abs(got[:, :, :2] - want[:, :, :2]).reshape(n, -1).max(1)
        tight = (dt <= TRACK_FEATURE_H) & (da <= TRACK_FEATURE_H)
        row = out[method] = {
            "frames": n, "frames_within_1e-4": int(tight.sum()),
            "translation_max_diff_px": float(dt.max()), "linear_max_diff": float(da.max()),
            "gmc_ms": float(np.mean(ms[1:])), "gmc_first_ms": ms[0]}
        log(f"{method} GMC against cv2: {row['frames_within_1e-4']} of {n} H within "
            f"{TRACK_FEATURE_H}; translation max |diff| {row['translation_max_diff_px']:.2e} px, "
            f"2x2 {row['linear_max_diff']:.2e}; {row['gmc_ms']:.2f} ms a frame (first "
            f"{row['gmc_first_ms']:.2f})")
        loose = method == "sift" and bool(((dt <= TRACK_SIFT_PX) &
                                           (da <= TRACK_SIFT_LINEAR)).all())
        if not (tight.all() or loose):
            raise SystemExit(f"{method}: the port's H is not cv2's")
    return out


def _hold_tracks(got, want, name, box_px):
    """Frame by frame: the same track IDs and classes, the boxes within
    `box_px`. Returns (largest box difference, track rows, distinct IDs);
    ends the script on a disagreement or where nothing was tracked."""
    box, rows, ids = 0.0, 0, set()
    for t, (g, w) in enumerate(zip(got, want)):
        a, b = g.boxes.data, w.boxes.data
        same = a.shape == b.shape and (a.shape[1] != 7 or (
            np.array_equal(a[:, 4], b[:, 4]) and np.array_equal(a[:, 6], b[:, 6])))
        if not same or len(got) != len(want):
            raise SystemExit(f"{name}: frame {t} has other tracks: {a[:, 4:].tolist()} against "
                             f"{b[:, 4:].tolist()}")
        if len(a) and a.shape[1] == 7:
            box = max(box, float(np.abs(a[:, :4] - b[:, :4]).max()))
            rows += len(a)
            ids |= set(a[:, 4].astype(int).tolist())
    log(f"{name}: {len(got)} frames, {rows} track rows, {len(ids)} IDs, equal frame by frame; "
        f"box max |diff| {box:.3e} px (limit {box_px})")
    if box > box_px or rows == 0:
        raise SystemExit(f"{name}: the tracks disagree beyond {box_px} px, or none was tracked")
    return box, rows, len(ids)


def phase_tracking(root):
    """Multi-object tracking through `YOLO.track` (see the module's text):
    ByteTrack, BoT-SORT (sparse optical flow) and BoT-SORT with ECC, ORB
    and SIFT over a seeded 1080 x 1920 pan. K1 launches once per forward, no
    other kernel. Returns (launches, rows, the pan's frames)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
    log(f"== phase 22: tracking: the flagship over a {TRACK_FRAMES}-frame "
        f"{TRACK_SHAPE[0]}x{TRACK_SHAPE[1]} pan at {IMGSZ} px; {', '.join(TRACK_TRACKERS)}; "
        f"float32 card vs CPU over {TRACK_HOLD_FRAMES} frames, b8 vs b1 over "
        f"{TRACK_B8_FRAMES}; bf16 track vs predict at b1 and b8 over {TRACK_TIMED_FRAMES}; GMC "
        f"against the known pan; "
        f"{', '.join(TRACK_FEATURE_TRACKERS)}: card vs CPU, GMC against cv2's, bf16 b1")
    t_phase = time.perf_counter()
    frames, offsets, scene = panning_sequence(TRACK_FRAMES, TRACK_SHAPE, seed=7)
    log(f"sequence: {len(frames)} frames, {len(scene['boxes'])} objects in the scene, made in "
        f"{time.perf_counter() - t_phase:.1f} s")
    from mgdt_yolo_tpu_torch.tracker import gmc
    from mgdt_yolo_tpu_torch.utils.build import HOST_GMC_FLAGS
    threads = gmc._lib().mgdt_gmc_set_threads(gmc.cpu_threads())
    log(f"GMC: {threads} threads (the process's CPUs {gmc.cpu_threads()}); g++ "
        f"{' '.join(HOST_GMC_FLAGS)}")
    yamls = _tracker_yamls(root)
    total, rows = no_launches(), {"trackers": {}}
    card = YOLO(WEIGHTS, device=DEVICE)

    def track(name, batch, n, **kw):
        """One counted, timed `YOLO.track` on the card over the first `n` frames."""
        out, wall, launches = _timed(lambda: card.track(
            frames[:n], imgsz=IMGSZ, tracker=yamls[name], batch=batch, **kw))
        _expect(launches, f"{name} b{batch}", deform_fwd=-(-n // batch))
        for k in total:
            total[k] += launches[k]
        return out, wall

    # float32 holds: the card against the CPU, b8 against b1
    cpu = YOLO(WEIGHTS, device="cpu")
    for name in TRACK_TRACKERS:
        r = rows["trackers"][name] = {}
        with float32_exact():
            b1, _ = track(name, 1, TRACK_B8_FRAMES)
            b8, _ = track(name, 8, TRACK_B8_FRAMES)
        t0 = time.perf_counter()
        on_cpu = cpu.track(frames[:TRACK_HOLD_FRAMES], imgsz=IMGSZ, tracker=yamls[name])
        r["cpu_s"] = time.perf_counter() - t0
        r["card_vs_cpu_box_px"], r["held_rows"], r["held_ids"] = _hold_tracks(
            b1[:TRACK_HOLD_FRAMES], on_cpu, f"{name}: card float32 vs CPU", TRACK_BOX_PX)
        r["b8_vs_b1_box_px"], _, _ = _hold_tracks(b8, b1, f"{name}: card float32 b8 vs b1",
                                                  TRACK_BOX_PX)
    del cpu
    # bf16: predict, each tracker, predict again, at b1 and b8; each tracker's
    # updates and GMC timed inside its run, its H held to the known pan; the
    # device's idle share under the profiler while BoT-SORT runs at b1
    timed = frames[:TRACK_TIMED_FRAMES]
    steps = -np.diff(offsets[:len(timed)], axis=0)
    for batch in TRACK_BATCHES:
        fps = {"predict": []}
        for turn in range(2):
            _, wall, launches = _timed(lambda: card.predict(timed, imgsz=IMGSZ, half=True,
                                                            conf=0.1, batch=batch))
            _expect(launches, f"predict b{batch}", deform_fwd=-(-len(timed) // batch))
            fps["predict"].append(len(timed) / wall)
            if turn:
                break
            for name in TRACK_TRACKERS:
                profiled = name == "botsort" and batch == 1
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) if profiled \
                    else contextlib.nullcontext()
                with _instrumented_tracking() as rec, prof:
                    res, wall = track(name, batch, len(timed), half=True)
                ids = set()
                for r_ in res:
                    if r_.boxes.is_track:
                        ids |= set(r_.boxes.id.astype(int).tolist())
                fps[name] = len(timed) / wall
                row = rows["trackers"][name][f"b{batch}"] = {
                    "frames_per_s": fps[name], "track_rows": sum(len(r_) for r_ in res),
                    "ids": len(ids), "update_ms_per_frame": sum(
                        ms for ms, _ in rec["update"]) / sum(n for _, n in rec["update"])}
                msg = (f"{name} b{batch}: {fps[name]:.2f} frames/s, {len(ids)} IDs; update "
                       f"{row['update_ms_per_frame']:.2f} ms a frame")
                if rec["H"]:
                    H = np.stack(rec["H"][1:])
                    row["gmc_ms"] = float(np.mean(rec["gmc_ms"][1:]))
                    row["gmc_first_ms"] = rec["gmc_ms"][0]
                    row["gmc_translation_err_px"] = float(np.abs(H[:, :, 2] - steps).max())
                    row["gmc_linear_err"] = float(np.abs(H[:, :, :2] - np.eye(2)).max())
                    msg += (f", of which GMC {row['gmc_ms']:.2f} (first frame "
                            f"{row['gmc_first_ms']:.2f}); H against the pan: translation max "
                            f"|err| {row['gmc_translation_err_px']:.4f} px (limit "
                            f"{TRACK_GMC_PX}), 2x2 max |err| {row['gmc_linear_err']:.2e} "
                            f"(limit {TRACK_GMC_LINEAR})")
                    if len(rec["H"]) != len(timed) or \
                            row["gmc_translation_err_px"] > TRACK_GMC_PX or \
                            row["gmc_linear_err"] > TRACK_GMC_LINEAR:
                        raise SystemExit(f"{name} b{batch}: the GMC's H misses the known pan")
                if profiled:
                    busy_us = sum(device_us(e) for e in prof.key_averages()
                                  if e.device_type == torch.autograd.DeviceType.CUDA)
                    row["device_idle_share"] = 1.0 - busy_us / (wall * 1e6)
                    row["device_busy_ms_per_frame"] = busy_us / 1e3 / len(timed)
                    msg += (f"; under the profiler: device busy {busy_us / 1e3:.1f} ms of "
                            f"{wall:.2f} s, idle share {row['device_idle_share']:.1%}")
                log(msg)
        for name in TRACK_TRACKERS:
            rows["trackers"][name][f"b{batch}"]["predict_frames_per_s"] = fps["predict"]
        log(f"b{batch} frames/s (bf16, {len(timed)} frames): predict "
            f"{' / '.join(f'{v:.2f}' for v in fps['predict'])} (before / after); " +
            "; ".join(f"{n} {fps[n]:.2f}" for n in TRACK_TRACKERS))
    # BoT-SORT with the ORB and SIFT GMC: the card against the CPU (float32),
    # the port's H against cv2's, bf16 b1 over the pan (its H is the
    # fixture's to hold: cv2's own misses the known pan by up to 0.86 px)
    t_features = time.perf_counter()
    cpu = YOLO(WEIGHTS, device="cpu")
    for name in TRACK_FEATURE_TRACKERS:
        r = rows["trackers"][name] = {}
        with float32_exact():
            b1, _ = track(name, 1, TRACK_HOLD_FRAMES)
        t0 = time.perf_counter()
        on_cpu = cpu.track(frames[:TRACK_HOLD_FRAMES], imgsz=IMGSZ, tracker=yamls[name])
        r["cpu_s"] = time.perf_counter() - t0
        r["card_vs_cpu_box_px"], r["held_rows"], r["held_ids"] = _hold_tracks(
            b1, on_cpu, f"{name}: card float32 vs CPU", TRACK_BOX_PX)
    del cpu
    rows["gmc_against_cv2"] = _gmc_against_cv2(frames)
    for name in TRACK_FEATURE_TRACKERS:
        with _instrumented_tracking() as rec:
            res, wall = track(name, 1, len(frames), half=True)
        ids = set()
        for r_ in res:
            if r_.boxes.is_track:
                ids |= set(r_.boxes.id.astype(int).tolist())
        row = rows["trackers"][name]["b1"] = {
            "frames_per_s": len(frames) / wall, "track_rows": sum(len(r_) for r_ in res),
            "ids": len(ids), "update_ms_per_frame": sum(
                ms for ms, _ in rec["update"]) / sum(n for _, n in rec["update"]),
            "gmc_ms": float(np.mean(rec["gmc_ms"][1:])), "gmc_first_ms": rec["gmc_ms"][0]}
        if len(rec["H"]) != len(frames):
            raise SystemExit(f"{name}: {len(rec['H'])} GMC calls over {len(frames)} frames")
        log(f"{name} b1: {row['frames_per_s']:.2f} frames/s (bf16, {len(frames)} frames), "
            f"{len(ids)} IDs; update {row['update_ms_per_frame']:.2f} ms a frame, of which GMC "
            f"{row['gmc_ms']:.2f} (first frame {row['gmc_first_ms']:.2f}); H held to cv2's "
            f"above, not to the known pan, which cv2's own ORB and SIFT miss by up to 0.86 px "
            f"(plain nearest-neighbour matches, a 3-px RANSAC threshold, a tiled scene)")
    rows["feature_trackers_s"] = time.perf_counter() - t_features
    log(f"ORB and SIFT trackers: {rows['feature_trackers_s']:.1f} s")
    rows["launches"] = total
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 22: {rows['phase_s']:.1f} s; launches {total}")
    log(f"phase 22 rows: {json.dumps(rows, default=float)}")
    return total, rows, frames


# phase 23: RT-DETR at 640 px and its published widths, seeded init
RTDETR_RATES = {1: 8, 8: 16, 32: 32}          # batch: scenes served a timed window
RTDETR_TRAIN, RTDETR_STEPS = 8, 4             # b8, accumulate 1 (nbs 8): an update a step
RTDETR_TOP = 100                              # the card's top queries held to the CPU's
RTDETR_HOLD = 1e-3                            # their boxes (normalised) and scores
RTDETR_FEAT_HOLD = 1e-3                       # the decoder's input maps, of their magnitude
RTDETR_OTHERS = ("rtdetr-x.yaml", "yolov8n-rtdetr.yaml")


def _bn_calibrated(model):
    """`model`'s state with every BatchNorm's statistics those of one
    train-mode forward of 8 synthetic scenes (momentum 1), as
    `_calibrated_state` sets them: at the plain seeded init the features
    fade through the deep backbone and every token would score the same."""
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad(), float32_exact():
        model(torch.from_numpy(synthetic_batch(8, IMGSZ)).to(model.device).float() / 255.0)
    return {k: v.cpu() for k, v in model.state_dict().items()}


def _query_distance(got, want):
    """The largest, over `got`'s RTDETR_TOP queries by best score, of the
    distance to the nearest query of `want` (rows: box, then class scores;
    the distance is the largest difference in a row)."""
    top = got[:, 4:].amax(-1).argsort(descending=True)[:RTDETR_TOP]
    return float((got[top, None] - want[None]).abs().amax(-1).amin(-1).max())


def _rtdetr_card_vs_cpu(name, state):
    """The float32 forward (TF32 off) of one synthetic scene at IMGSZ on
    the card against the CPU's float64 forward of the same weights, in two
    parts. The decoder's input maps: within RTDETR_FEAT_HOLD of their
    magnitude, or 4x the CPU's own float32 distance from its float64 where
    that is larger (a deep random backbone amplifies rounding). The decoder
    alone: the CPU's float64 decoder run on the card's maps; each of the
    card's RTDETR_TOP queries (by best score) has a query of it whose box
    (normalised xywh) and class scores lie within RTDETR_HOLD (the nearest
    by its largest difference: near-tied queries may swap places). The
    whole model's query distance is logged beside (a map difference of
    1e-3 moves tokens across the encoder's top-300 cut). Returns the row."""
    from mgdt_yolo_tpu_torch.nn.tasks import RTDETRDetectionModel
    x = torch.from_numpy(synthetic_batch(1, IMGSZ, seed=23)).float() / 255.0
    runs, cpu_s = {}, {}
    for key, dev, dtype in (("card", DEVICE, torch.float32), ("cpu32", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        model = RTDETRDetectionModel(name, device="cpu")
        model.load_state_dict(state)
        model = model.to(device=dev, dtype=dtype).eval()
        dec = getattr(model, f"model_{model.specs[-1].i}")
        seen = {}
        hook = dec.register_forward_pre_hook(
            lambda m, args: seen.setdefault("maps", [t.detach() for t in args[0]]))
        t0 = time.perf_counter()
        with torch.no_grad(), float32_exact():
            boxes, scores = model(x.to(dev, dtype))[:2]
        cpu_s[key] = time.perf_counter() - t0
        hook.remove()
        runs[key] = {"rows": torch.cat([boxes[-1, 0], scores[-1, 0]], -1).double().cpu(),
                     "maps": [t.double().cpu() for t in seen["maps"]], "dec": dec}
    card, cpu32, cpu64 = runs["card"], runs["cpu32"], runs["cpu64"]

    def map_err(got, want):
        return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for a, b in zip(got, want))
    feat, own = map_err(card["maps"], cpu64["maps"]), map_err(cpu32["maps"], cpu64["maps"])
    feat_limit = max(RTDETR_FEAT_HOLD, 4 * own)
    with torch.no_grad():
        ref = cpu64["dec"](card["maps"])
    ref_rows = torch.cat([ref[0][-1, 0], ref[1][-1, 0]], -1)
    dec_err = _query_distance(card["rows"], ref_rows)
    whole = _query_distance(card["rows"], cpu64["rows"])
    ok = feat <= feat_limit and dec_err <= RTDETR_HOLD and bool(torch.isfinite(card["rows"]).all())
    log(f"{name} at {IMGSZ} px float32 card vs CPU float64: the decoder's maps within {feat:.3e} "
        f"of their magnitude (limit {feat_limit:.3e}; the CPU's own float32 {own:.3e}); the "
        f"decoder alone on the card's maps: the card's top {RTDETR_TOP} of "
        f"{card['rows'].shape[0]} queries each within {dec_err:.3e} of a CPU query (limit "
        f"{RTDETR_HOLD:.0e}); the whole model's {whole:.3e}; best score "
        f"{float(card['rows'][:, 4:].max()):.4f}; CPU forwards {cpu_s['cpu32']:.1f} / "
        f"{cpu_s['cpu64']:.1f} s (float32 / float64) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the card and the CPU disagree")
    return {"queries": int(card["rows"].shape[0]), "maps_max_rel_diff": feat,
            "cpu_float32_maps_max_rel_diff": own, "maps_limit": feat_limit,
            "decoder_top_max_abs_diff": dec_err, "whole_model_top_max_abs_diff": whole,
            "cpu_forward_s": cpu_s["cpu64"]}


def _vocab_card_vs_cpu():
    """`models.vocab.VOCABULARY` (every item-17 type, a `Detect` head, nc 3):
    its float32 fused forward of one scene on the card against the CPU's
    float64 one, at phase 13's limits (raw maps 1e-3 of their magnitude,
    boxes 0.5 px, scores 1e-3); then its bf16 fused forward at b8 timed."""
    from mgdt_yolo_tpu_torch.models.vocab import VOCABULARY
    state = _bn_calibrated(DetectionModel(VOCABULARY, device=DEVICE))
    x = torch.from_numpy(synthetic_batch(1, IMGSZ, seed=23)).float() / 255.0
    outs = []
    for dev, dtype in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        model = DetectionModel(VOCABULARY, device="cpu")
        model.load_state_dict(state)
        model = model.to(device=dev, dtype=dtype).eval().fuse()
        with torch.no_grad(), float32_exact():
            decoded, maps = model(x.to(dev, dtype))
        outs.append(([m.double().cpu() for m in maps], decoded.double().cpu()))
    (mg, dg), (mc, dc) = outs
    raw = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(mg, mc))
    box = float((dg[:, :4] - dc[:, :4]).abs().max())
    score = float((dg[:, 4:] - dc[:, 4:]).abs().max())
    ok = raw <= ABLATION_RAW_TOL and box < 0.5 and score <= 1e-3
    model = DetectionModel(VOCABULARY, device=DEVICE)
    model.load_state_dict(state)
    model.eval().fuse().to(torch.bfloat16)
    xb = torch.from_numpy(synthetic_batch(8, IMGSZ)).to(DEVICE).to(torch.bfloat16) / 255.0
    with torch.no_grad():
        ms = cuda_time_ms(lambda: model(xb), iters=5, windows=3)
    log(f"vocabulary config (every item-17 type; strides {list(model.stride)}, "
        f"{sum(p.numel() for p in model.parameters()):,} parameters): float32 card vs CPU "
        f"float64 raw maps {raw:.3e} of their magnitude (limit {ABLATION_RAW_TOL:.0e}), boxes "
        f"{box:.3e} px, scores {score:.3e}; bf16 fused b8 {ms:.3f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the vocabulary config: the card and the CPU disagree")
    return {"raw_max_rel_diff": raw, "box_max_abs_diff": box, "score_max_abs_diff": score,
            "bf16_b8_ms": ms}


def _matcher_timed():
    """While open, every `HungarianMatcher` call is timed from a synchronise
    at its entry (the forward's device work is not charged to it) to its
    indices on the card: {"ms": [...]}."""
    from mgdt_yolo_tpu_torch.vit.utils import ops as vops
    rec, call = {"ms": []}, vops.HungarianMatcher.__call__

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, *a, **kw)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    @contextlib.contextmanager
    def ctx():
        vops.HungarianMatcher.__call__ = timed
        try:
            yield rec
        finally:
            vops.HungarianMatcher.__call__ = call
    return ctx()


def _rtdetr_training(state):
    """`RTDETRTrainer` on rtdetr-l from `state`: RTDETR_STEPS b8 steps of
    fresh synthetic scenes at 640 px (bf16 autocast, the host pipeline with
    every augmentation at 0, mosaic forced 0, nbs 8: an update each step;
    the batches taken from the loader first, so the steps alone are timed),
    each step timed (host clock, synchronised) with its matcher calls and
    its stages (`train_step`'s marks, a synchronise at each), the device's
    idle share over the steps after the first (torch.profiler);
    finite losses; then one validation on the EMA weights
    (`RTDETRValidator`). Returns the row."""
    from mgdt_yolo_tpu_torch.nn.tasks import RTDETRDetectionModel
    from mgdt_yolo_tpu_torch.vit.rtdetr import RTDETRTrainer, RTDETRValidator
    model = RTDETRDetectionModel("rtdetr-l.yaml", device=DEVICE)
    model.load_state_dict(state)
    ds = SyntheticDetectionDataset(n=RTDETR_TRAIN * RTDETR_STEPS, imgsz=IMGSZ, nc=model.nc,
                                   seed=0)
    trainer = RTDETRTrainer(model, DataLoader(ds, RTDETR_TRAIN, IMGSZ),
                            overrides={"batch": RTDETR_TRAIN, "nbs": RTDETR_TRAIN, "epochs": 1,
                                       "val": False, **UNAUGMENTED, **NO_PLOTS})
    if not trainer.amp or trainer.args["mosaic"] != 0.0 or trainer.accumulate != 1:
        raise SystemExit(f"RT-DETR trainer: amp {trainer.amp}, mosaic "
                         f"{trainer.args['mosaic']}, accumulate {trainer.accumulate}")
    steps, losses, matcher, split = [], [], [], []
    batches = [to_device(b, DEVICE) for b in trainer.loader]
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with _matcher_timed() as rec:
        for i, b in enumerate(batches):
            with prof if i == 1 else contextlib.nullcontext():  # profiled: steps 2 on
                if i == 1:
                    torch.cuda.synchronize()
                    t_loop = time.perf_counter()
                for b in batches[i:] if i == 1 else [b]:
                    torch.cuda.synchronize()
                    t0, n0 = time.perf_counter(), len(rec["ms"])
                    stamps = [("start", t0)]
                    m = trainer.train_step(b, mark=lambda name: (
                        torch.cuda.synchronize(), stamps.append((name, time.perf_counter()))))
                    torch.cuda.synchronize()
                    steps.append((time.perf_counter() - t0) * 1e3)
                    split.append({n: (t - t_prev) * 1e3 for (_, t_prev), (n, t)
                                  in zip(stamps, stamps[1:])})
                    matcher.append(sum(rec["ms"][n0:]))
                    losses.append(float(m["loss"]))
                if i == 1:
                    wall = time.perf_counter() - t_loop
                    break
    busy_us = sum(device_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    calls = len(rec["ms"]) // max(1, len(steps))
    if len(steps) != RTDETR_STEPS or not np.isfinite(losses).all() or calls != 7:
        raise SystemExit(f"RT-DETR training: {len(steps)} steps, losses {losses}, "
                         f"{calls} matcher calls a step")
    later = steps[1:]
    stages = {k: float(np.mean([sp[k] for sp in split[1:]])) for k in split[0]}
    row = {"step_ms": steps, "matcher_ms": matcher, "losses": losses, "stage_ms_after_first": stages,
           "images_per_s_after_first": RTDETR_TRAIN * len(later) / (sum(later) / 1e3),
           "matcher_share_after_first": sum(matcher[1:]) / sum(later),
           "matcher_calls_per_step": calls, "device_idle_share": 1.0 - busy_us / (wall * 1e6)}
    t0 = time.perf_counter()
    metrics = trainer.validate()
    row["val_s"] = time.perf_counter() - t0
    row["val"] = {k: metrics[k] for k in ("precision", "recall", "map50", "map")}
    if not isinstance(trainer.validator, RTDETRValidator):
        raise SystemExit("RT-DETR training validated with another validator")
    log(f"rtdetr-l training b{RTDETR_TRAIN} bf16: steps {', '.join(f'{v:.1f}' for v in steps)} "
        f"ms, losses {', '.join(f'{v:.3f}' for v in losses)}; after the first "
        f"{row['images_per_s_after_first']:.2f} images/s, the matcher "
        f"{', '.join(f'{v:.1f}' for v in matcher)} ms a step ({calls} calls: encoder + 6 "
        f"layers), {row['matcher_share_after_first']:.1%} of the step; after the first, by "
        f"stage (synchronised at each): "
        f"{', '.join(f'{k} {v:.1f}' for k, v in stages.items())} ms; device idle "
        f"{row['device_idle_share']:.1%} over steps 2-{len(steps)} ({wall:.2f} s, profiled, "
        f"batches resident); EMA "
        f"validation {row['val_s']:.1f} s, mAP50-95 {row['val']['map']:.4f}")
    del trainer, model
    return row


def _rtdetr_pt_hold(state, root):
    """rtdetr-l with `state` written as a reference `.pt`
    (`tools/reference_pt.py`) and read back through `vit.RTDETR(pt)` on the
    card: no key missed, its state bit for bit `state` rounded through fp16,
    its b1 float32 forward (TF32 off) bit for bit that of a live model
    carrying the same rounded state; no kernel launched. Returns its row."""
    from mgdt_yolo_tpu_torch.nn.tasks import RTDETRDetectionModel
    from mgdt_yolo_tpu_torch.tools.reference_pt import write_reference_pt
    from mgdt_yolo_tpu_torch.vit import RTDETR
    before = read_counts()
    t_hold = time.perf_counter()
    src = RTDETRDetectionModel("rtdetr-l.yaml", device=DEVICE)
    src.load_state_dict(state)
    t0 = time.perf_counter()
    path = write_reference_pt(src, root / "rtdetr" / "rtdetr-l.pt")
    write_s = time.perf_counter() - t0
    del src
    t0 = time.perf_counter()
    y = RTDETR(str(path), device=DEVICE)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    report = y.model.import_report
    if report["shape_missed"] or report["name_missed"]:
        raise SystemExit(f"rtdetr-l .pt: missed {report['shape_missed'][:3]} "
                         f"{report['name_missed'][:3]}")
    rounded = {k: v.half().float() if v.is_floating_point() else v for k, v in state.items()}
    got = {k: v.cpu() for k, v in y.model.state_dict().items()}
    differ = [k for k, v in rounded.items() if v.is_floating_point() and not torch.equal(got[k], v)]
    if set(got) != set(rounded) or differ:
        raise SystemExit(f"rtdetr-l .pt: the state is not the source's through fp16: {differ[:5]}")
    live = RTDETRDetectionModel("rtdetr-l.yaml", device=DEVICE)
    live.load_state_dict(rounded)
    x = torch.from_numpy(synthetic_batch(1, IMGSZ)).to(DEVICE).float() / 255.0
    with torch.no_grad(), float32_exact():
        a, b = y.model(x), live(x)
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(a[:4], b[:4]))
    launches = {k: v - before[k] for k, v in read_counts().items()}
    row = {"bytes": path.stat().st_size, "write_s": write_s, "read_s": read_s,
           "hold_s": time.perf_counter() - t_hold, "matched": report["matched"],
           "forward_bitwise": same, "launches": launches}
    log(f"rtdetr-l .pt ({row['bytes'] / 1e6:.1f} MB, fp16): written in {write_s:.2f} s, read "
        f"through RTDETR(pt) onto the card in {read_s:.2f} s; {report['matched']} keys "
        f"matched, 0 missed; the state the source's through fp16 bit for bit; the b1 float32 "
        f"forward {'bit for bit' if same else 'NOT bit for bit'} the live model's on that "
        f"state; {sum(launches.values())} kernel launches; the hold {row['hold_s']:.1f} s (two "
        f"more models built on the card)")
    if not same:
        raise SystemExit("rtdetr-l .pt: the forward differs from the live model's")
    _expect(launches, "the RT-DETR .pt hold")
    del y, live
    return row


def phase_rtdetr(root):
    """RT-DETR (see the module's text): rtdetr-l served through `RTDETR`
    in bf16 at b1, b8 and b32, held in float32 against the CPU's float64,
    written as a reference `.pt` and read back through `RTDETR(pt)`,
    trained through `RTDETRTrainer` and validated on its EMA weights;
    rtdetr-x, yolov8n-rtdetr and the vocabulary config card against CPU. No
    hand kernel is on this path: every count must stay 0. Returns
    (launches, rows)."""
    from mgdt_yolo_tpu_torch.nn.tasks import RTDETRDetectionModel
    from mgdt_yolo_tpu_torch.vit import RTDETR
    log(f"== phase 23: RT-DETR: rtdetr-l at {IMGSZ} px (hd 256, nq 300, 6 decoder layers, "
        f"3 levels, AIFI on 20x20) served bf16 at b1/b8/b32, float32 card vs CPU float64, "
        f"a reference .pt through RTDETR(pt), {RTDETR_STEPS} b{RTDETR_TRAIN} training steps + "
        f"EMA validation; "
        f"{', '.join(RTDETR_OTHERS)} and the vocabulary config card vs CPU")
    t_phase = time.perf_counter()
    reset_counts()
    rows = {"steps_s": {}}
    t_step = [t_phase]

    def step(name):  # the seconds since the last step, by name
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows["steps_s"][name] = now - t_step[0]
        t_step[0] = now

    state = _bn_calibrated(RTDETRDetectionModel("rtdetr-l.yaml", device=DEVICE))
    step("calibrate")
    rows["card_vs_cpu"] = {"rtdetr-l.yaml": _rtdetr_card_vs_cpu("rtdetr-l.yaml", state)}
    step("card_vs_cpu")
    rows["pt"] = _rtdetr_pt_hold(state, root)
    torch.cuda.empty_cache()
    step("pt_hold")
    y = RTDETR("rtdetr-l.yaml", device=DEVICE)
    y.model.load_state_dict(state)
    dec = getattr(y.model, f"model_{y.model.specs[-1].i}")
    scenes = _scenes(max(RTDETR_RATES.values()))
    first = y.predict(scenes[:1], half=True, imgsz=IMGSZ)  # builds the bf16 predictor
    served = getattr(y.predictor.model, f"model_{y.model.specs[-1].i}")
    if len(first[0].boxes) > dec.nq or not isinstance(served.input_proj_bn_0, torch.nn.Identity) \
            or next(served.parameters()).dtype != torch.bfloat16:
        raise SystemExit("rtdetr-l serving: not a folded bf16 model, or too many detections")
    rows["serving"] = {}
    for b, n in RTDETR_RATES.items():
        y.predict(scenes[:b], batch=b)  # warm this batch shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = y.predict(scenes[:n], batch=b)
        wall = time.perf_counter() - t0
        det = sum(len(r.boxes) for r in res)
        rows["serving"][f"b{b}"] = {
            "images": n, "wall_s": wall, "images_per_s": n / wall, "detections": det,
            **{f"{k}_ms_per_image": float(np.mean([r.speed[k] for r in res]))
               for k in ("preprocess", "inference")}}
        if len(res) != n:
            raise SystemExit(f"rtdetr-l b{b}: {len(res)} results for {n} images")
    xb = torch.from_numpy(synthetic_batch(32, IMGSZ)).to(DEVICE).to(torch.bfloat16) / 255.0
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: y.predictor.model(xb), iters=3, windows=3)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.predict(scenes[:RTDETR_RATES[8]], batch=8)
        wall = time.perf_counter() - t0
    busy_us = sum(device_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    rows["serving"].update(forward_b32_ms=fwd_ms, b8_device_idle_share=1.0 - busy_us / (wall * 1e6))
    log("rtdetr-l RTDETR.predict bf16 (fused, stretched to 640, conf 0.25, no NMS): " +
        "; ".join(f"b{b} {r['images_per_s']:.2f} images/s ({r['images']} images, "
                  f"{r['detections']} detections; per image preprocess "
                  f"{r['preprocess_ms_per_image']:.2f} ms, inference "
                  f"{r['inference_ms_per_image']:.2f} ms)"
                  for b, r in ((k[1:], v) for k, v in rows["serving"].items()
                               if k.startswith("b") and isinstance(v, dict))) +
        f"; the b32 forward alone {fwd_ms:.3f} ms ({32e3 / fwd_ms:.2f} images/s); device idle "
        f"{rows['serving']['b8_device_idle_share']:.1%} under b8 (profiled)")
    del y
    torch.cuda.empty_cache()
    step("serving")
    rows["training"] = _rtdetr_training(state)
    torch.cuda.empty_cache()
    step("training")
    for name in RTDETR_OTHERS:
        other = _bn_calibrated(RTDETRDetectionModel(name, device=DEVICE))
        rows["card_vs_cpu"][name] = _rtdetr_card_vs_cpu(name, other)
        torch.cuda.empty_cache()
        step(name)
    rows["card_vs_cpu"]["vocabulary"] = _vocab_card_vs_cpu()
    step("vocabulary")
    total = read_counts()
    _expect(total, "the RT-DETR path")
    rows["launches"] = total
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 23: {rows['phase_s']:.1f} s (" +
        ", ".join(f"{k} {v:.1f}" for k, v in rows["steps_s"].items()) + f"); launches {total}")
    log(f"phase 23 rows: {json.dumps(rows, default=float)}")
    return total, rows


# phase 24: SAM at the published ViT-B widths (`sam_b`: 768 wide, 12 blocks,
# 12 heads, global attention in blocks 2/5/8/11, 14-windows elsewhere; 64x64
# tokens at 1024 px) from the port's seeded init (no SAM checkpoint is in the
# repository), and auto_annotate over phase 15's val JPEGs
SAM_IMGSZ = 1024
SAM_HOLD = 1e-3                 # the embedding and the low-res logits, of their magnitude
SAM_IOU_HOLD = 1e-4             # the predicted IoUs
SAM_PREDICT_SIZES = ((1080, 1920), (480, 640))
SAM_PREDICT_RUNS = 3            # timed prompted predictions a scene, after a warm-up one
SAM_GRID = 8                    # generate's points_per_side (JAX's default)
ANNOTATE_SAM_IMGSZ = 256        # auto_annotate's default
ANNOTATE_MASK_AGREE = 0.999     # each SAM mask's share of pixels equal to the CPU's
SAM_TOP_KERNELS = 6             # the bf16 encoder's largest kernels logged


def _sam_card_vs_cpu(sam, img):
    """The float32 encoder (TF32 off) of one scene at SAM_IMGSZ on the card
    against the CPU's float64 (within SAM_HOLD of its magnitude, or 4x the
    CPU's own float32 distance from it where that is larger: the CPU's
    float32 forward runs only where the card misses SAM_HOLD); then a
    prompted decode on the card's embedding against the CPU's float64
    decoder on the same embedding: the low-res logits within SAM_HOLD of
    their magnitude, the predicted IoUs within SAM_IOU_HOLD. Returns the
    row."""
    x, scale, (h0, w0) = sam._prep(img)
    pts = np.array([[[w0 * 0.5, h0 * 0.5], [w0 * 0.3, h0 * 0.7]]], np.float32) * scale
    lab = np.array([[1, 0]])
    with torch.no_grad(), float32_exact():
        emb = sam.module.encode_image(x)
        masks, iou = sam.decode(emb, pts, lab)
    cpu_s = {}

    def cpu_encode(dtype):
        m = copy.deepcopy(sam.module).to("cpu", dtype)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = m.encode_image(x.cpu()).double()
        cpu_s[str(dtype)] = time.perf_counter() - t0
        return m, out
    m, ref = cpu_encode(torch.float64)
    with torch.no_grad():
        ref_m, ref_i = m.decode(emb.cpu().double(), torch.from_numpy(pts).double(),
                                torch.from_numpy(lab))
    del m
    mag = float(ref.abs().max())
    err = float((emb.double().cpu() - ref).abs().max()) / mag
    own = None  # the CPU's own float32 distance, computed only where it could matter
    if err > SAM_HOLD:
        own = float((cpu_encode(torch.float32)[1] - ref).abs().max()) / mag
    limit = max(SAM_HOLD, 4 * (own or 0.0))
    mask_mag = float(ref_m.abs().max())
    mask_err = float((masks.double().cpu() - ref_m).abs().max()) / mask_mag
    iou_err = float((iou.double().cpu() - ref_i).abs().max())
    ok = err <= limit and mask_err <= SAM_HOLD and iou_err <= SAM_IOU_HOLD and \
        bool(torch.isfinite(emb).all() and torch.isfinite(masks).all())
    own_text = "not run: within 1e-3" if own is None else f"{own:.3e}"
    log(f"sam_b at {SAM_IMGSZ} px, float32 card (TF32 off) vs CPU float64: the image embedding "
        f"{tuple(emb.shape)} within {err:.3e} of its magnitude {mag:.3f} (limit {limit:.3e}; "
        f"the CPU's own float32 {own_text}); a 2-point decode on the card's embedding: low-res "
        f"logits {tuple(masks.shape)} within {mask_err:.3e} of their magnitude {mask_mag:.3f} "
        f"(limit {SAM_HOLD:.0e}), IoUs within {iou_err:.3e} (limit {SAM_IOU_HOLD:.0e}); CPU "
        f"encoder forwards (s) {cpu_s} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("sam_b: the card and the CPU disagree")
    return {"embedding_max_rel_diff": err, "cpu_float32_max_rel_diff": own,
            "embedding_limit": limit, "mask_logits_max_rel_diff": mask_err,
            "iou_max_abs_diff": iou_err, "cpu_encoder_s": cpu_s}


def _sam_predict_split(sam, img):
    """`SAM.predict`'s wall time on one BGR scene, split into its steps
    (host clock, each ended by a synchronise): prep (the host's resize and
    the canvas's upload), encode, decode, postprocess (the masks' resizes
    on the card and their copy back). Min of each over SAM_PREDICT_RUNS
    after a warm-up prediction."""
    sam.predict(img)
    parts = {k: [] for k in ("prep", "encode", "decode", "postprocess", "total")}
    for _ in range(SAM_PREDICT_RUNS):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        x, scale, (h0, w0) = sam._prep(img)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        emb = sam.encode(x)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        masks, iou = sam.decode(emb, np.array([[[w0 / 2, h0 / 2]]], np.float32) * scale,
                                np.ones((1, 1)))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = sam._postprocess_masks(masks, scale, (h0, w0)).cpu().numpy()
        t.append(time.perf_counter())
        for k, a, b in zip(("prep", "encode", "decode", "postprocess"), t, t[1:]):
            parts[k].append((b - a) * 1e3)
        parts["total"].append((t[-1] - t[0]) * 1e3)
        if out.shape != (1, 3, h0, w0) or not np.isfinite(out).all():
            raise SystemExit(f"SAM.predict on {img.shape}: masks {out.shape}")
    return {k: min(v) for k, v in parts.items()}


def _annotate_both(sam_card, sam_cpu, det_card, det_cpu, val_dir, png_dir, root):
    """`auto_annotate` with the flagship and `sam_b` at ANNOTATE_SAM_IMGSZ in
    float32 on the card over the val JPEGs and on the CPU over their PNG
    twins (the CPU decodes no JPEG: the twins hold the card decoder's
    pixels); each SAM mask recorded before contouring, the time in SAM's
    predictions and in the contour tracing summed. Returns {dev: (label
    dir, masks, wall s, {"sam_s", "contours_s"})}."""
    from mgdt_yolo_tpu_torch.data.utils import auto_annotate
    from mgdt_yolo_tpu_torch.utils import contours
    out = {}
    trace = contours.find_external_contours
    for dev, sam, det, src in (("card", sam_card, det_card, val_dir),
                               ("cpu", sam_cpu, det_cpu, png_dir)):
        masks, predict, spent = [], sam.predict, {"sam_s": 0.0, "contours_s": 0.0}

        def recorded(image, points=None, labels=None, multimask=True, predict=predict,
                     masks=masks, spent=spent):
            t = time.perf_counter()
            m, i = predict(image, points=points, labels=labels, multimask=multimask)
            spent["sam_s"] += time.perf_counter() - t
            masks.append(m[0, 0] > 0)
            return m, i

        def timed_trace(mask, spent=spent):
            t = time.perf_counter()
            found = trace(mask)
            spent["contours_s"] += time.perf_counter() - t
            return found
        sam.predict, contours.find_external_contours = recorded, timed_trace
        try:
            with float32_exact():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                labels = auto_annotate(str(src), det_model=det, sam_model=sam,
                                       out_dir=str(root / f"annotate_{dev}"), imgsz=IMGSZ,
                                       sam_imgsz=ANNOTATE_SAM_IMGSZ)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            del sam.predict
            contours.find_external_contours = trace
        out[dev] = (labels, masks, wall, spent)
    return out


def phase_sam(root):
    """SAM and auto_annotate (see the module's text). No hand kernel is on
    SAM's path: every count must stay 0; auto_annotate's detector, the
    flagship, launches K1 once a forward on the card, and nothing else.
    Returns (SAM's launches, auto_annotate's launches, rows)."""
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.utils.draw import imwrite
    from mgdt_yolo_tpu_torch.vit.sam import SAM
    from mgdt_yolo_tpu_torch.vit.sam.amg import build_point_grid
    log(f"== phase 24: SAM: sam_b at {SAM_IMGSZ} px (768 wide, 12 blocks, 12 heads, global "
        f"blocks 2/5/8/11, 14-windows; seeded init) float32 card vs CPU float64, the encoder "
        f"timed in float32 and bf16, predict on "
        f"{' and '.join(f'{h}x{w}' for h, w in SAM_PREDICT_SIZES)} "
        f"split by step, generate at points_per_side {SAM_GRID}; auto_annotate with the "
        f"flagship and sam_b at {ANNOTATE_SAM_IMGSZ} px over phase 15's val JPEGs, card vs CPU")
    t_phase = time.perf_counter()
    reset_counts()
    rows = {}
    sam = SAM("sam_b", img_size=SAM_IMGSZ, device=DEVICE)
    scenes = {s: next(im for im in _scenes(len(SCENE_SIZES)) if im.shape[:2] == s)
              for s in SAM_PREDICT_SIZES}
    rows["card_vs_cpu"] = _sam_card_vs_cpu(sam, scenes[SAM_PREDICT_SIZES[0]])
    torch.cuda.empty_cache()

    x = sam._prep(scenes[SAM_PREDICT_SIZES[0]])[0]
    bf16 = copy.deepcopy(sam.module).to(torch.bfloat16)
    with torch.no_grad():
        with float32_exact():
            f32_ms = cuda_time_ms(lambda: sam.module.encode_image(x), iters=3, windows=3)
        bf16_ms = cuda_time_ms(lambda: bf16.encode_image(x), iters=3, windows=3)
        # where the bf16 forward's device time goes, by kernel
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            bf16.encode_image(x)
            torch.cuda.synchronize()
    kernels = sorted(((e.key, device_us(e) / 1e3) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    del bf16
    torch.cuda.empty_cache()
    rows["encoder_b1_ms"] = {"float32": f32_ms, "bf16": bf16_ms, "bf16_device_ms": busy,
                             "bf16_top_kernels_ms": dict(kernels[:SAM_TOP_KERNELS])}
    log(f"sam_b encoder at b1, {SAM_IMGSZ} px (CUDA events, min of 3 windows of 3): float32 "
        f"(TF32 off) {f32_ms:.3f} ms, bf16 {bf16_ms:.3f} ms ({f32_ms / bf16_ms:.2f}x); the bf16 "
        f"forward's device time {busy:.3f} ms (profiled), its largest kernels: " +
        "; ".join(f"{k[:70]} {ms:.3f} ms ({ms / busy:.1%})"
                  for k, ms in kernels[:SAM_TOP_KERNELS]))

    rows["predict_ms"] = {}
    for s, img in scenes.items():
        r = rows["predict_ms"][f"{s[0]}x{s[1]}"] = _sam_predict_split(sam, img)
        log(f"SAM.predict on {s[0]}x{s[1]} (centre point, float32; min of {SAM_PREDICT_RUNS} "
            f"runs, ms): total {r['total']:.2f} = prep {r['prep']:.2f} + encode "
            f"{r['encode']:.2f} + decode {r['decode']:.2f} + postprocess {r['postprocess']:.2f}")

    # generate at JAX's default threshold, and at the median of this seeded
    # model's predicted IoUs (its IoU head predicts near 0, so 0.7 keeps
    # none), so that the stability filter, the masks' resizes, the 16-pixel
    # floor and the de-duplication run on half the candidates
    img = scenes[SAM_PREDICT_SIZES[1]]
    x, scale, (h0, w0) = sam._prep(img)
    grid = (build_point_grid(SAM_GRID) * np.array([w0, h0], np.float32))[:, None, :] * scale
    _, ious = sam.decode(sam.encode(x), grid.astype(np.float32), np.ones((SAM_GRID ** 2, 1)))
    rows["generate"] = {}
    for thresh in (0.7, float(ious.float().median())):
        sam.generate(img, points_per_side=SAM_GRID, pred_iou_thresh=thresh)  # warm-up
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept = sam.generate(img, points_per_side=SAM_GRID, pred_iou_thresh=thresh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(device_us(e) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if not all(k["segmentation"].shape == img.shape[:2] and k["area"] >= 16 for k in kept):
            raise SystemExit("SAM.generate: a mask of the wrong shape or under 16 pixels")
        passed = int((ious.reshape(-1) > thresh).sum())
        r = rows["generate"][f"iou_thresh_{thresh:.6g}"] = {
            "points": SAM_GRID ** 2, "candidates": 3 * SAM_GRID ** 2,
            "passed_iou": passed, "kept": len(kept), "wall_s": wall,
            "device_idle_share": 1.0 - busy_us / (wall * 1e6)}
        log(f"SAM.generate on {img.shape[0]}x{img.shape[1]}, points_per_side {SAM_GRID}, "
            f"pred_iou_thresh {thresh:.6g}: {passed} of {3 * SAM_GRID ** 2} candidates pass "
            f"the IoU filter, {len(kept)} masks kept, {wall:.3f} s; device idle "
            f"{r['device_idle_share']:.1%} (profiled)")
    del sam
    torch.cuda.synchronize()
    sam_total = read_counts()
    _expect(sam_total, "the SAM path")
    torch.cuda.empty_cache()

    val_dir = root / "pigs" / "images" / "val"
    if not val_dir.is_dir():  # the phase run alone
        _write_disk_dataset(root / "pigs")
    png_dir = root / "sam_png"
    png_dir.mkdir()
    files = sorted(val_dir.iterdir())
    for f in files:
        imwrite(png_dir / f"{f.stem}.png", native.decode(f))
    reset_counts()
    runs = _annotate_both(SAM("sam_b", img_size=ANNOTATE_SAM_IMGSZ, device=DEVICE),
                          SAM("sam_b", img_size=ANNOTATE_SAM_IMGSZ, device="cpu"),
                          YOLO(WEIGHTS, device=DEVICE), YOLO(WEIGHTS, device="cpu"),
                          val_dir, png_dir, root)
    (card_dir, card_masks, wall, split), (cpu_dir, cpu_masks, cpu_wall, _) = \
        runs["card"], runs["cpu"]
    names = sorted(p.name for p in card_dir.iterdir())
    if names != sorted(p.name for p in cpu_dir.iterdir()) or len(names) != len(files):
        raise SystemExit(f"auto_annotate wrote {names} on the card and "
                         f"{sorted(p.name for p in cpu_dir.iterdir())} on the CPU")
    lines = {}
    for n in names:
        got = [ln.split()[0] for ln in (card_dir / n).read_text().splitlines() if ln]
        want = [ln.split()[0] for ln in (cpu_dir / n).read_text().splitlines() if ln]
        if got != want:
            raise SystemExit(f"auto_annotate {n}: classes {got} on the card, {want} on the CPU")
        lines[n] = len(got)
    if len(card_masks) != len(cpu_masks) or not card_masks:
        raise SystemExit(f"auto_annotate: {len(card_masks)} SAM masks on the card, "
                         f"{len(cpu_masks)} on the CPU")
    agree = [float((a == b).mean()) for a, b in zip(card_masks, cpu_masks)]
    same_text = sum((card_dir / n).read_text() == (cpu_dir / n).read_text() for n in names)
    rows["auto_annotate"] = {"images": len(files), "prompts": len(card_masks),
                             "lines": sum(lines.values()), "s_per_image": wall / len(files),
                             "cpu_s_per_image": cpu_wall / len(files),
                             "card_split_s": {**split, "detector_and_rest_s":
                                              wall - split["sam_s"] - split["contours_s"]},
                             "min_mask_agreement": min(agree), "files_identical": same_text}
    log(f"auto_annotate (flagship at {IMGSZ} px, sam_b at {ANNOTATE_SAM_IMGSZ} px, float32) over "
        f"{len(files)} val JPEGs: {len(card_masks)} prompts, {sum(lines.values())} label lines; "
        f"{wall / len(files):.3f} s per image on the card (of the run's {wall:.2f} s: SAM "
        f"{split['sam_s']:.2f}, contour tracing {split['contours_s']:.2f}, the detector and the "
        f"rest {wall - split['sam_s'] - split['contours_s']:.2f}; {cpu_wall / len(files):.3f} s "
        f"per image on the CPU over the PNG twins); label files: the same names, line counts "
        f"and classes, "
        f"{same_text} of {len(names)} identical to the byte; each SAM mask at least "
        f"{min(agree):.5%} of its pixels the CPU's (limit {ANNOTATE_MASK_AGREE:.1%})")
    if min(agree) < ANNOTATE_MASK_AGREE:
        raise SystemExit("auto_annotate: a SAM mask on the card differs from the CPU's")
    torch.cuda.synchronize()
    annotate_total = read_counts()
    _expect(annotate_total, "auto_annotate", deform_fwd=len(files))
    rows["launches"] = {"sam": sam_total, "auto_annotate": annotate_total}
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 24: {rows['phase_s']:.1f} s; launches: SAM {sam_total}, auto_annotate "
        f"{annotate_total}")
    log(f"phase 24 rows: {json.dumps(rows, default=float)}")
    return sam_total, annotate_total, rows


ENSEMBLE_BATCH = 8
ENSEMBLE_HOLD_SCENES = 8          # the float32 card-vs-CPU hold: one batch
HELPER_HOLD = 1e-5                # CBAM, the assigner's scores, NMS rows: of their magnitude
DCN_S2_HOLD = 1e-4                # DyDCNv2 card vs CPU (K1's float32 limit, phase 3)
PROFILE_BATCH, TRACE_BATCH, PROFILE_RUNS = 32, 8, 5


def _ensemble_card_vs_cpu(paths, scenes):
    """The float32 ensemble (TF32 off) through the predictor on the card and
    on the CPU over the first scenes: phase 8's serving holds (the same
    counts and classes, boxes within 0.5 px)."""
    from mgdt_yolo_tpu_torch.nn.tasks import attempt_load_weights
    runs = []
    for dev in (DEVICE, "cpu"):
        p = _entry_predictor(attempt_load_weights(paths, device=dev), dev)
        with float32_exact():
            runs.append(p(scenes, batch=ENSEMBLE_BATCH))
    return _hold_results(*runs, "ensemble float32 card vs CPU")


def _nms_over_members(ens, scenes):
    """The predictor's step on one letterboxed batch against NMS over the
    members' own decoded outputs, concatenated: the same detections, bit
    for bit."""
    x, _ = letterbox_batch(scenes[:ENSEMBLE_BATCH], IMGSZ)
    x = torch.from_numpy(x).to(DEVICE)
    with torch.no_grad():
        det, counts = infer(ens, x, predictor.CONF, predictor.IOU, predictor.MAX_DET)
        xf = x.float() / 255.0
        decoded = torch.cat([m(xf)[0] for m in ens.members], dim=-1)
        det2, counts2 = non_max_suppression(decoded, conf_thres=predictor.CONF,
                                            iou_thres=predictor.IOU, max_det=predictor.MAX_DET)
    if not (torch.equal(det, det2) and torch.equal(counts, counts2)):
        raise SystemExit("ensemble: the detections are not NMS over the members' outputs")
    return int(counts.sum())


def _helpers_card_vs_cpu():
    """CBAM, heuristic_assign_v2 (b4 over the 80x80 stride-8 anchors) and
    the per-image NMS (seeded boxes whose scores tie), float32 on the card
    (TF32 off) against the CPU; DyDCNv2 at stride 2 (the plain exact DCN on
    both devices, K1 not launched) and at stride 1 without its norm (K1
    with its bias). Returns (rows, K1 launches made)."""
    from mgdt_yolo_tpu_torch.nn.modules.conv import CBAM
    from mgdt_yolo_tpu_torch.ops.nms import nms_single, nms_single_fixpoint
    from mgdt_yolo_tpu_torch.utils.tal import heuristic_assign_v2
    rows = {}
    g = torch.Generator().manual_seed(25)

    def seeded(module):
        with torch.no_grad():
            for prm in module.parameters():
                prm.copy_(torch.rand(prm.shape, generator=g) * 0.4 - 0.2)
        return module

    def run_both(fn):
        outs = []
        for dev in (DEVICE, "cpu"):
            with torch.no_grad(), float32_exact():
                outs.append(fn(dev))
            torch.cuda.synchronize()
        return outs

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())

    cbam = seeded(CBAM(32, 7))
    x = torch.randn(4, 32, 80, 80, generator=g)
    a, b = run_both(lambda dev: copy.deepcopy(cbam).to(dev)(x.to(dev)))
    rows["cbam_rel_err"] = rel(a, b)

    B_, G_, nc = 4, 8, 2
    ys, xs = torch.meshgrid(torch.arange(80) + 0.5, torch.arange(80) + 0.5, indexing="ij")
    anc = torch.stack([xs.reshape(-1), ys.reshape(-1)], 1) * 8
    A = anc.shape[0]
    ps = torch.rand(B_, A, nc, generator=g)
    ctr = anc[None] + torch.randn(B_, A, 2, generator=g) * 6
    wh = torch.rand(B_, A, 2, generator=g) * 120 + 10
    pb = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    gxy = torch.rand(B_, G_, 2, generator=g) * 500
    gb = torch.cat([gxy, gxy + torch.rand(B_, G_, 2, generator=g) * 120 + 20], -1)
    gl = torch.randint(0, nc, (B_, G_), generator=g)
    mg = torch.ones(B_, G_, dtype=torch.bool)
    mg[1, 5:] = False
    gb[~mg] = 0
    a, b = run_both(lambda dev: heuristic_assign_v2(
        *(t.to(dev) for t in (ps, pb, anc, gl, gb, mg)), num_classes=nc))
    for name in ("target_labels", "target_gt_idx", "fg_mask", "target_bboxes"):
        if not torch.equal(getattr(a, name).cpu(), getattr(b, name)):
            raise SystemExit(f"heuristic_assign_v2: {name} differs between the card and the CPU")
    rows["assign_v2"] = {"fg": int(b.fg_mask.sum()), "score_rel_err": rel(a.target_scores,
                                                                           b.target_scores),
                         "max_target_score": b.target_scores.max().item()}

    centres = torch.rand(12, 2, generator=g) * 560 + 40
    c = centres[torch.randint(0, 12, (4000,), generator=g)] + torch.randn(4000, 2, generator=g) * 8
    bwh = torch.rand(4000, 2, generator=g) * 60 + 20
    boxes = torch.cat([c - bwh / 2, c + bwh / 2], 1)
    scores = torch.randint(0, 16, (4000, nc), generator=g).float() / 16
    rows["nms"] = {}
    for name, fn in (("nms_single", lambda dev: nms_single(boxes.to(dev), scores.to(dev))),
                     ("nms_single_fixpoint", lambda dev: nms_single_fixpoint(
                         boxes.to(dev), scores.to(dev), pre_topk=1024)),
                     ("nms_single_fixpoint_block", lambda dev: nms_single_fixpoint(
                         boxes.to(dev), scores.to(dev), pre_topk=1024, block=256))):
        a, b = run_both(fn)
        if int(a[1]) != int(b[1]) or not int(b[1]) or rel(a[0], b[0]) > HELPER_HOLD:
            raise SystemExit(f"{name}: the card kept {int(a[1])} rows, the CPU {int(b[1])}, or "
                             f"their rows differ")
        rows["nms"][name] = {"kept": int(b[1]), "row_rel_err": rel(a[0], b[0])}

    rows["dydcnv2"] = {}
    k1 = 0
    for stride, with_norm in ((2, True), (2, False), (1, False)):
        m = seeded(DyDCNv2(32, 32, stride=stride, with_norm=with_norm))
        ho = (80 - 1) // stride + 1
        xi = torch.randn(8, 32, 80, 80, generator=g)
        off = torch.rand(8, 18, ho, ho, generator=g) * 5 - 2.5
        msk = torch.rand(8, 9, ho, ho, generator=g)
        reset_counts()
        a, b = run_both(lambda dev: copy.deepcopy(m).to(dev)(*(t.to(dev) for t in (xi, off, msk))))
        launched = read_counts()
        want = 1 if stride == 1 else 0
        _expect(launched, f"DyDCNv2 stride {stride} with_norm {with_norm}", deform_fwd=want)
        k1 += want
        err = rel(a, b)
        rows["dydcnv2"][f"stride{stride}_norm{int(with_norm)}"] = {"rel_err": err,
                                                                    "k1_launches": want}
        if err > DCN_S2_HOLD:
            raise SystemExit(f"DyDCNv2 stride {stride}: the card and the CPU differ by {err:.3e}")
    worst = max(rows["cbam_rel_err"], rows["assign_v2"]["score_rel_err"])
    log(f"card vs CPU, float32: CBAM {rows['cbam_rel_err']:.3e}, heuristic_assign_v2 "
        f"{rows['assign_v2']['fg']} positives (labels, gts, boxes, masks equal; scores "
        f"{rows['assign_v2']['score_rel_err']:.3e}, the largest "
        f"{rows['assign_v2']['max_target_score']:.4f} > 1 as the reference's), "
        + ", ".join(f"{k} {v['kept']} rows equal" for k, v in rows["nms"].items())
        + "; DyDCNv2 " + ", ".join(f"{k} {v['rel_err']:.3e} (K1 {v['k1_launches']})"
                                   for k, v in rows["dydcnv2"].items())
        + f" (limits {HELPER_HOLD}, {DCN_S2_HOLD} of the magnitude)")
    if worst > HELPER_HOLD:
        raise SystemExit("CBAM or heuristic_assign_v2: the card and the CPU disagree")
    return rows, k1


def phase_helpers(root):
    """The JAX package's public helpers on the card (see the module's text).
    Returns (the helpers path's launches, rows)."""
    from mgdt_yolo_tpu_torch.nn.tasks import attempt_load_weights
    from mgdt_yolo_tpu_torch.utils.checks import check_bf16
    from mgdt_yolo_tpu_torch.utils.torch_utils import (Profile, model_info, start_trace,
                                                       stop_trace)
    from mgdt_yolo_tpu_torch.weights import save_npz
    log(f"== phase 25: the public helpers: an NMS ensemble (the committed flagship and a seeded "
        f"gd_thead_yolov8) through the predictor at b{ENSEMBLE_BATCH} in float32 and bf16, "
        f"model_info at {IMGSZ} px card vs CPU, Profile and a Chrome trace, check_bf16, CBAM, "
        f"heuristic_assign_v2, the per-image NMS and DyDCNv2 at stride 2 card vs CPU")
    t_phase = time.perf_counter()
    rows, total = {}, no_launches()

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    second = DetectionModel("gd_thead_yolov8.yaml", nc=2, device="cpu")
    second_npz = save_npz(second, root / "helpers" / "gd_thead_seeded.npz",
                          {"model_yaml": second.model_yaml, "nc": 2,
                           "deform_semantics": "windowed"})
    paths = [WEIGHTS, second_npz]
    scenes = _scenes(N_SCENES)
    rows["ensemble"] = {}
    for dtype, half in (("float32", False), ("bf16", True)):
        ens = attempt_load_weights(paths, device=DEVICE)
        p = _entry_predictor(ens, DEVICE, half=half)
        with float32_exact() if not half else contextlib.nullcontext():
            _, launches, row = _timed_predict(p, scenes, ENSEMBLE_BATCH,
                                              f"ensemble of 2 ({dtype}) b{ENSEMBLE_BATCH}",
                                              forwards_per_batch=2)
        add(launches)
        reset_counts()
        with float32_exact() if not half else contextlib.nullcontext():
            row["detections_checked"] = _nms_over_members(ens, scenes)
        torch.cuda.synchronize()
        check = read_counts()
        _expect(check, "the ensemble's NMS check", deform_fwd=4)  # 2 members, twice
        add(check)
        rows["ensemble"][dtype] = row
        del ens, p
    reset_counts()
    rows["ensemble"]["box_max_abs_diff_f32"] = _ensemble_card_vs_cpu(
        paths, scenes[:ENSEMBLE_HOLD_SCENES])
    torch.cuda.synchronize()
    hold = read_counts()
    _expect(hold, "the ensemble's card-vs-CPU hold", deform_fwd=2)
    add(hold)

    reset_counts()
    card = model_info(DetectionModel.from_npz(WEIGHTS, device=DEVICE), IMGSZ, verbose=False)
    torch.cuda.synchronize()
    flops = read_counts()
    _expect(flops, "get_flops on the card", deform_fwd=1)  # K1 inside mgdt::deform_fwd
    add(flops)
    cpu = model_info(DetectionModel.from_npz(WEIGHTS, device="cpu"), IMGSZ, verbose=False)
    rows["model_info"] = {"card": card, "cpu": cpu}
    log(f"model_info of the flagship at {IMGSZ} px: card (K1 inside mgdt::deform_fwd) {card}; "
        f"CPU (the plain version inside it) {cpu}")
    if card != cpu:
        raise SystemExit("get_flops / model_info: the card and the CPU count differently")

    model = DetectionModel.from_npz(WEIGHTS, device=DEVICE).fuse().to(torch.bfloat16)
    xb = torch.from_numpy(synthetic_batch(PROFILE_BATCH, IMGSZ)).to(DEVICE).float() / 255.0
    reset_counts()
    prof_ms, event_ms = [], []
    with torch.no_grad():
        model(xb)
        for _ in range(PROFILE_RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with Profile(DEVICE) as pr:
                start.record()
                model(xb)
                end.record()
            prof_ms.append(pr.dt * 1e3)
            event_ms.append(start.elapsed_time(end))
        trace_dir = start_trace(root / "helpers" / "trace")
        model(xb[:TRACE_BATCH])
        trace = Path(stop_trace())
    torch.cuda.synchronize()
    runs = read_counts()
    _expect(runs, "Profile and the trace", deform_fwd=PROFILE_RUNS + 2)
    add(runs)
    text = trace.read_text()
    k1_name = KERNEL_SYMBOLS["deform_fwd"][0]
    rows["profile"] = {"batch": PROFILE_BATCH, "profile_ms": prof_ms, "events_ms": event_ms,
                       "trace_mb": trace.stat().st_size / 2 ** 20,
                       "trace_k1_events": text.count(k1_name)}
    log(f"Profile around a b{PROFILE_BATCH} bf16 forward, {PROFILE_RUNS} runs: "
        f"{min(prof_ms):.3f} ms (min; host clock with a synchronise at each end) against CUDA "
        f"events on the same window {min(event_ms):.3f} ms; trace {trace} "
        f"({rows['profile']['trace_mb']:.2f} MB) names {k1_name} "
        f"{rows['profile']['trace_k1_events']} times")
    if trace.parent != Path(trace_dir) or not rows["profile"]["trace_k1_events"]:
        raise SystemExit("the Chrome trace does not name K1's kernel")
    del model, xb
    if not check_bf16(DEVICE):
        raise SystemExit("check_bf16 fails on the card")
    log("check_bf16 on the card: True")

    rows["card_vs_cpu"], k1 = _helpers_card_vs_cpu()
    total["deform_fwd"] += k1
    rows["launches"] = total
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 25: {rows['phase_s']:.1f} s; launches {total}")
    log(f"phase 25 rows: {json.dumps(rows, default=float)}")
    return total, rows


# phase 26: video files, HTTP streams and mixed image formats as sources
VIDEO_FPS = 25.0
VIDEO_BATCHES = (1, 8)
VIDEO_FIXTURES = FIXTURES / "video"
VIDEO_HOLD = (0, 21, 42, 63)        # the pan's frames held to draw.jpeg_reading
MIXED_FORMATS = ("jpg", "png", "bmp", "tif")
WEBP_FIXTURES = FIXTURES / "webp"
WEBP_SCENES = ("scene_lossy", "scene_lossless")  # 1080x1920, timed and predicted over
WEBP_SCENE = 7  # their picture: synthetic_scene(7, 1920)[:1080] (tests/torch_webp_fixtures.py)
WEBP_DIGESTS = WEBP_FIXTURES / "digests.json"   # cv2's reading of the scenes (no PNG twin)
# MPEG-4 Part 2 and VP8 (tests/torch_video_fixtures.py): cv2's fps, size and
# frame digests in codecs.json; the mp4v clip is also tracked and predicted over
VIDEO_CODECS = VIDEO_FIXTURES / "codecs.json"
VIDEO_CODEC_CLIPS = ("pan1080.mp4", "pan1080.webm", "mpeg4_4mv.avi", "vp8_v1_sharp.webm",
                     "vp8_v3.webm", "vp8_resilient.webm")
VIDEO_MP4V = VIDEO_FIXTURES / "pan1080.mp4"


def _riff(cid, body):
    return cid + len(body).to_bytes(4, "little") + body + b"\0" * (len(body) & 1)


def _avi_bytes(jpegs, size, fps):
    """A Motion JPEG AVI (with `idx1`) of `jpegs` at an integer `fps`."""
    import struct
    w, h = size
    n = len(jpegs)
    avih = struct.pack("<14I", int(1e6 / fps), 0, 0, 0x10, n, 0, 1, 0, w, h, 0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, int(fps), 0, n, 0,
                                     0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = _riff(b"LIST", b"hdrl" + _riff(b"avih", avih) + _riff(
        b"LIST", b"strl" + _riff(b"strh", strh) + _riff(b"strf", strf)))
    movi, idx, off = [], [], 4
    for j in jpegs:
        c = _riff(b"00dc", j)
        idx.append(b"00dc" + struct.pack("<III", 0x10, off, len(j)))
        movi.append(c)
        off += len(c)
    return _riff(b"RIFF", b"AVI " + hdrl + _riff(b"LIST", b"movi" + b"".join(movi)) +
                 _riff(b"idx1", b"".join(idx)))


def _ebml(eid, body):
    """A Matroska element: its ID's bytes, an 8-byte size, the body."""
    if isinstance(body, int):
        body = body.to_bytes(8, "big").lstrip(b"\0") or b"\0"
    elif isinstance(body, str):
        body = body.encode()
    return eid + b"\x01" + len(body).to_bytes(7, "big") + body


def _mkv_bytes(jpegs, size, fps):
    """A Matroska file of `jpegs` as V_MJPEG SimpleBlocks, one cluster."""
    e = bytes.fromhex
    header = _ebml(e("1A45DFA3"), _ebml(e("4286"), 1) + _ebml(e("42F7"), 1) +
                   _ebml(e("42F2"), 4) + _ebml(e("42F3"), 8) + _ebml(e("4282"), "matroska") +
                   _ebml(e("4287"), 4) + _ebml(e("4285"), 2))
    info = _ebml(e("1549A966"), _ebml(e("2AD7B1"), 1000000) + _ebml(e("4D80"), "chip_smoke"))
    track = _ebml(e("AE"), _ebml(e("D7"), 1) + _ebml(e("73C5"), 1) + _ebml(e("83"), 1) +
                  _ebml(e("86"), "V_MJPEG") + _ebml(e("23E383"), int(round(1e9 / fps))) +
                  _ebml(e("E0"), _ebml(e("B0"), size[0]) + _ebml(e("BA"), size[1])))
    blocks = b"".join(_ebml(e("A3"), b"\x81" + int(round(k * 1000 / fps)).to_bytes(2, "big") +
                            b"\x80" + j) for k, j in enumerate(jpegs))
    cluster = _ebml(e("1F43B675"), _ebml(e("E7"), 0) + blocks)
    return header + _ebml(e("18538067"), info + _ebml(e("1654AE6B"), track) + cluster)


@contextlib.contextmanager
def _mjpeg_server(jpegs):
    """A loopback HTTP server in a thread serving `jpegs` as one Motion JPEG
    stream (`multipart/x-mixed-replace`, as an IP camera); yields its URL."""
    import http.server

    class Camera(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            for j in jpegs:
                self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\nContent-Length: %d"
                                 b"\r\n\r\n" % len(j) + j + b"\r\n")
            self.wfile.write(b"--frame--\r\n")

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Camera)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}/stream"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()


def _nvdec_probe():
    """Whether NVDEC's library loads and its headers are in the toolkit."""
    try:
        ctypes.CDLL("libnvcuvid.so.1")
        lib = "loads"
    except OSError as e:
        lib = f"does not load ({e})"
    cuda = Path(nvcc_path()).resolve().parents[1]
    dirs = [cuda / "include", *sorted(cuda.glob("targets/*/include")), Path("/usr/include")]
    headers = {h: [str(d) for d in dirs if (d / h).is_file()] for h in ("nvcuvid.h",
                                                                         "cuviddec.h")}
    return {"libnvcuvid.so.1": lib, "headers": headers}


def _track_in_turns(card, path, frames, what, add):
    """`YOLO.track` (ByteTrack, bf16) over the video file `path` and over
    its `frames` in memory at each of VIDEO_BATCHES, in turns (file, memory,
    memory, file): frames/s of each, the tracks bit for bit, K1 once a
    forward, one tracker keyed by the file's path. Returns rows by batch."""
    n, out_rows = len(frames), {}
    for batch in VIDEO_BATCHES:
        fps, outs = {"file": [], "memory": []}, {}
        for src in ("file", "memory", "memory", "file"):
            out, wall, launches = _timed(lambda: card.track(
                str(path) if src == "file" else frames, imgsz=IMGSZ, tracker="bytetrack.yaml",
                batch=batch, half=True))
            _expect(launches, f"{what} track b{batch} from {src}", deform_fwd=-(-n // batch))
            add(launches)
            fps[src].append(n / wall)
            outs.setdefault(src, out)
        if len(outs["file"]) != n or list(card.predictor.trackers) != [str(path)]:
            raise SystemExit(f"the {what} file's run did not track every frame on the video's "
                             "tracker")
        box, track_rows, ids = _hold_tracks(outs["file"], outs["memory"],
                                            f"{what} b{batch}: file vs memory", 0.0)
        out_rows[f"b{batch}"] = {"file_frames_per_s": fps["file"],
                                 "memory_frames_per_s": fps["memory"],
                                 "track_rows": track_rows, "ids": ids}
        from_file, from_memory = (" / ".join(f"{v:.2f}" for v in fps[k])
                                  for k in ("file", "memory"))
        log(f"{what} track b{batch} (ByteTrack, bf16, {n} frames): from the file {from_file} "
            f"frames/s, from memory {from_memory} (in turns); K1 {-(-n // batch)} a run")
    return out_rows


def _codec_clips(card, vdir, mjpeg_ms, add):
    """The committed MPEG-4 Part 2 and VP8 clips on the card's host: every
    frame's SHA-256 cv2's (`codecs.json`), with cv2's fps and size; the ms a
    frame of two decodes of each (a new reader each, one thread, YUV to BGR
    included) beside the Motion JPEG frame's; `YOLO.track` over the mp4v
    clip against its frames in memory; `predict(save=True)` over it at b8,
    its video read back. Returns rows."""
    from mgdt_yolo_tpu_torch.native.video import VideoReader
    codecs, rows, clip = json.loads(VIDEO_CODECS.read_text()), {}, {}
    for name in VIDEO_CODEC_CLIPS:
        fx, times = codecs[name], []
        for _ in range(2):
            r = VideoReader(VIDEO_FIXTURES / name)
            t0 = time.perf_counter()
            imgs = r.read(range(r.frames))
            times.append((time.perf_counter() - t0) / max(r.frames, 1) * 1e3)
        digests = [None if isinstance(i, native.DecodeError) else _sha256(i) for i in imgs]
        equal = digests == fx["sha256"] and (r.fps, list(r.size)) == (fx["fps"], fx["size"])
        rows[name] = {"frames": r.frames, "fps": r.fps, "size": list(r.size),
                      "decode_ms_per_frame": times, "equal_to_cv2": equal}
        log(f"{name} ({r.size[0]}x{r.size[1]}, {r.frames} frames at {r.fps} fps): every frame "
            f"cv2's by SHA-256: {equal}; decode {' / '.join(f'{t:.3f}' for t in times)} ms a "
            f"frame (host, one thread, to BGR), beside this run's Motion JPEG frame's "
            f"{mjpeg_ms:.3f} (nvJPEG, batches of 8)")
        if not equal:
            raise SystemExit(f"{name}: the port's frames are not cv2's reading")
        clip[name] = imgs
    frames = clip[VIDEO_MP4V.name]
    n = len(frames)
    rows["track"] = _track_in_turns(card, VIDEO_MP4V, frames, "mp4v", add)
    out, wall, launches = _timed(lambda: card.predict(
        str(VIDEO_MP4V), imgsz=IMGSZ, half=True, batch=8, save=True,
        project=str(vdir / "runs"), name="predict_mp4v"))
    _expect(launches, "mp4v predict(save=True) b8", deform_fwd=-(-n // 8))
    add(launches)
    r = VideoReader(vdir / "runs" / "predict_mp4v" / VIDEO_MP4V.name)
    rows["save"] = {"frames_per_s": n / wall, "frames": r.frames, "fps": r.fps, "size": r.size,
                    "detections": sum(len(x) for x in out)}
    log(f"mp4v predict(save=True) b8: {n / wall:.2f} frames/s, {rows['save']['detections']} "
        f"detections; its video read back: {r.frames} frames, {r.fps} fps, "
        f"{r.size[0]}x{r.size[1]}")
    if (r.frames, r.fps, r.size) != (n, VIDEO_FPS, (1920, 1080)) or len(out) != n:
        raise SystemExit("mp4v predict(save=True) wrote another video")
    return rows


def phase_video(root, frames=None, decode_rows=None):
    """Video files, an HTTP stream and image formats as the predictor's and
    the tracker's sources (see the module's text). Returns (launches, rows)."""
    from PIL import Image
    from mgdt_yolo_tpu_torch import YOLO
    from mgdt_yolo_tpu_torch.data.loaders import LoadStreams
    from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
    from mgdt_yolo_tpu_torch.native.video import VideoReader, VideoWriter
    from mgdt_yolo_tpu_torch.utils import draw
    log(f"== phase 26: video sources: phase 22's {TRACK_FRAMES}-frame {TRACK_SHAPE[0]}x"
        f"{TRACK_SHAPE[1]} pan written by the port's MP4 writer (and as AVI and MKV), the "
        "committed fixtures, YOLO.track over the file against the same frames in memory, "
        "predict(save=True), the MPEG-4 Part 2 and VP8 clips (cv2's digests, decode ms, "
        "YOLO.track and predict(save=True) over the mp4v one), an HTTP Motion JPEG stream, "
        "the WebP fixtures, a directory of jpg/png/bmp/tif/webp")
    t_phase = time.perf_counter()
    if frames is None:
        frames = panning_sequence(TRACK_FRAMES, TRACK_SHAPE, seed=7)[0]
    n, (H, W) = len(frames), frames[0].shape[:2]
    total, rows = no_launches(), {}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    vdir = root / "video"
    vdir.mkdir()
    # 1. the port's writer, the same JPEG bytes in AVI and MKV, read back
    mp4 = vdir / "pan.mp4"
    t0 = time.perf_counter()
    writer = VideoWriter(mp4, VIDEO_FPS, (W, H))
    for f in frames:
        writer.write(f)
    writer.release()
    rows["writer_ms_per_frame"] = (time.perf_counter() - t0) / n * 1e3
    jpegs = VideoReader(mp4).frame_bytes(range(n))
    (vdir / "pan.avi").write_bytes(_avi_bytes(jpegs, (W, H), VIDEO_FPS))
    (vdir / "pan.mkv").write_bytes(_mkv_bytes(jpegs, (W, H), VIDEO_FPS))
    for ext in ("mp4", "avi", "mkv"):
        r = VideoReader(vdir / f"pan.{ext}")
        got = (r.frames, r.fps, r.size)
        if got != (n, VIDEO_FPS, (W, H)) or r.frame_bytes(range(r.frames)) != jpegs:
            raise SystemExit(f"pan.{ext} reads back as {got} or with other frames")
    log(f"writer: {n} frames {W}x{H} at {VIDEO_FPS} fps, {rows['writer_ms_per_frame']:.2f} ms "
        f"a frame (encode_jpeg + write), {mp4.stat().st_size / 2 ** 20:.1f} MB; MP4, AVI and "
        "MKV read back: frame count, fps, size and every frame's bytes exact")
    reader = VideoReader(mp4)
    reader.read(range(8))  # nvJPEG's handle and buffers
    t0 = time.perf_counter()
    decoded = []
    for s in range(0, n, 8):
        decoded += reader.read(range(s, min(s + 8, n)))
    rows["decode_ms_per_frame"] = (time.perf_counter() - t0) / n * 1e3
    if any(isinstance(d, native.DecodeError) for d in decoded):
        raise SystemExit("a frame of the port's MP4 did not decode")
    held = []
    for k in VIDEO_HOLD:
        _libjpeg_q95(frames[k], vdir / f"q95_{k}.jpg")
        held.append(draw.jpeg_reading(decoded[k], frames[k],
                                      native.decode(vdir / f"q95_{k}.jpg")))
    rows["jpeg_reading"] = held
    phase15 = (decode_rows or {}).get("1080x1920", {})
    log(f"decode (nvJPEG, batches of 8 on 8 threads): {rows['decode_ms_per_frame']:.3f} ms a "
        f"frame; phase 15's 1080x1920 JPEG: {phase15.get('decode_ms', float('nan')):.3f} ms "
        f"one image, {phase15.get('decode_batch32_ms_per_image', float('nan')):.3f} ms in a "
        f"batch of 32; frames {VIDEO_HOLD} against draw.jpeg_reading: " + "; ".join(
            f"mean {h['mean_diff']:.3f} max {h['max_diff']} gap {h['psnr_gap_db']:.3f} dB"
            for h in held))
    if not all(h["holds"] for h in held):
        raise SystemExit("the port's MP4 frames read back outside draw.jpeg_reading's bound")
    # 2. the committed fixtures against their twins
    fixtures = {}
    for ext in ("avi", "mp4", "mkv", "gif"):
        r = VideoReader(VIDEO_FIXTURES / f"clip.{ext}")
        imgs = r.read(range(r.frames))
        twins = sorted(VIDEO_FIXTURES.glob(("gif" if ext == "gif" else "clip") + "_*.png"))
        if len(imgs) != len(twins) or any(isinstance(i, native.DecodeError) for i in imgs):
            raise SystemExit(f"clip.{ext}: {len(imgs)} frames for {len(twins)} twins")
        d = np.stack([np.abs(i.astype(np.int16) - native.decode(t)) for i, t in zip(imgs, twins)])
        fixtures[ext] = {"frames": len(imgs), "fps": r.fps, "max_diff": int(d.max()),
                         "mean_diff": float(d.mean())}
        log(f"fixture clip.{ext}: {len(imgs)} frames at {r.fps} fps, against its twins max "
            f"|diff| {d.max()}, mean {d.mean():.4f}")
        if (ext == "gif" and d.max()) or d.max() > JPEG_MAX_DIFF or d.mean() >= JPEG_MEAN_DIFF:
            raise SystemExit(f"clip.{ext} is outside its limit (GIF exact; Motion JPEG max "
                             f"{JPEG_MAX_DIFF}, mean < {JPEG_MEAN_DIFF})")
    rows["fixtures"] = fixtures
    # 3. YOLO.track over the file against the same frames in memory, in turns
    card = YOLO(WEIGHTS, device=DEVICE)
    rows["track"] = _track_in_turns(card, mp4, decoded, "Motion JPEG", add)
    # 4. predict(save=True) over the video, its MP4 read back
    out, wall, launches = _timed(lambda: card.predict(
        str(mp4), imgsz=IMGSZ, half=True, batch=8, save=True, project=str(vdir / "runs"),
        name="predict"))
    _expect(launches, "predict(save=True) b8", deform_fwd=-(-n // 8))
    add(launches)
    r = VideoReader(vdir / "runs" / "predict" / "pan.mp4")
    rows["save"] = {"frames_per_s": n / wall, "frames": r.frames, "fps": r.fps, "size": r.size}
    log(f"predict(save=True) b8: {n / wall:.2f} frames/s; pan.mp4 read back: {r.frames} frames, "
        f"{r.fps} fps, {r.size[0]}x{r.size[1]}")
    if (r.frames, r.fps, r.size) != (n, VIDEO_FPS, (W, H)) or len(out) != n:
        raise SystemExit("predict(save=True) wrote another video")
    # 4b. MPEG-4 Part 2 and VP8: the committed clips held to cv2's digests,
    # their decode on the host (one video, one thread), YOLO.track over the
    # mp4v clip against its frames in memory and predict(save=True) over it
    rows["codecs"] = _codec_clips(card, vdir, rows["decode_ms_per_frame"], add)
    # 5. the same frames from a loopback HTTP Motion JPEG stream
    with _mjpeg_server(jpegs) as url:
        t0 = time.perf_counter()
        streamed = [it["img"] for it in LoadStreams(url)]
        wall = time.perf_counter() - t0
    same = len(streamed) == n and all(np.array_equal(a, b) for a, b in zip(streamed, decoded))
    rows["stream"] = {"frames": len(streamed), "frames_per_s": len(streamed) / wall,
                      "equal_to_file": same}
    log(f"HTTP stream: {len(streamed)} frames at {len(streamed) / wall:.2f} frames/s (read and "
        f"decoded a frame at a time); equal to the file's frames: {same}")
    if not same:
        raise SystemExit("the stream's frames differ from the file's")
    # 6. the WebP fixtures against cv2's reading, and the decode of 1080p WebP
    webp, digests, scene_px = {}, json.loads(WEBP_DIGESTS.read_text()), {}
    for f in sorted(WEBP_FIXTURES.glob("*.webp")):
        got = native.decode(f)
        if f.stem in digests:
            scene_px[f.stem] = got
            equal = digests[f.stem] == {"shape": list(got.shape),
                                        "sha256": hashlib.sha256(got.tobytes()).hexdigest()}
        else:
            want = native.decode(f.with_suffix(".png"))
            equal = got.shape == want.shape and np.array_equal(got, want)
        webp[f.stem] = {"shape": list(got.shape), "equal": bool(equal)}
    bad = [k for k, v in webp.items() if not v["equal"]]
    log(f"WebP fixtures: {len(webp)} files, each bit for bit cv2's reading (its PNG twin or "
        f"its digest): {not bad}")
    if bad or len(webp) < 2 or sorted(scene_px) != sorted(WEBP_SCENES):
        raise SystemExit(f"WebP fixtures differ from cv2's reading: {bad}")
    rows["webp_fixtures"] = webp
    # the same picture as a quality-95 JPEG (as phase 15 writes its dataset), timed beside them
    picture = np.ascontiguousarray(synthetic_scene(WEBP_SCENE, 1920, seed=7)[:1080])
    if not np.array_equal(scene_px["scene_lossless"], picture):
        raise SystemExit(f"the lossless WebP scene is not synthetic scene {WEBP_SCENE}")
    jpg = vdir / "scene_q95.jpg"
    Image.fromarray(np.ascontiguousarray(picture[..., ::-1])).save(jpg, quality=95)
    rows["webp_decode"] = _decode_ms({**{k: WEBP_FIXTURES / f"{k}.webp" for k in WEBP_SCENES},
                                      "scene_q95_jpeg": jpg})
    log("1080x1920 decode of one picture (host, ms a picture): " + "; ".join(
        f"{k} {v['decode_ms']:.3f} one image, {v['decode_batch32_ms_per_image']:.3f} in a batch "
        f"of 32" for k, v in rows["webp_decode"].items()) +
        f"; phase 15's JPEG {phase15.get('decode_ms', float('nan')):.3f} / "
        f"{phase15.get('decode_batch32_ms_per_image', float('nan')):.3f}")
    # 7. a directory of mixed formats against the same pixels as arrays
    mixed = vdir / "mixed"
    mixed.mkdir()
    for i, img in enumerate(_scenes(2 * len(MIXED_FORMATS))):
        ext = MIXED_FORMATS[i % len(MIXED_FORMATS)]
        p = mixed / f"im{i:02d}.{ext}"
        if ext in ("jpg", "png"):
            draw.imwrite(p, img)
        else:
            Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(p)
    for k in WEBP_SCENES:
        shutil.copyfile(WEBP_FIXTURES / f"{k}.webp", mixed / f"{k}.webp")
    files = sorted(str(p) for p in mixed.iterdir())
    # a WebP's pixels are cv2's reading (its digest held above), the others' the port's
    arrays = [scene_px[Path(f).stem] if f.endswith(".webp") else native.decode(f)
              for f in files]
    by_dir, _, launches = _timed(lambda: card.predict(str(mixed), imgsz=IMGSZ, half=True,
                                                      batch=4))
    by_arrays, _, launches2 = _timed(lambda: card.predict(arrays, imgsz=IMGSZ, half=True,
                                                          batch=4))
    for got in (launches, launches2):
        _expect(got, "the mixed directory b4", deform_fwd=-(-len(files) // 4))
        add(got)
    dets = sum(len(r_) for r_ in by_dir)
    if [r_.path for r_ in by_dir] != files or dets == 0 or any(
            not np.array_equal(a.boxes.data, b.boxes.data) for a, b in zip(by_dir, by_arrays)):
        raise SystemExit("the mixed directory's detections differ from the arrays'")
    webp_dets = {Path(r_.path).stem: len(r_) for r_ in by_dir if r_.path.endswith(".webp")}
    if 0 in webp_dets.values():
        raise SystemExit(f"a WebP scene gave no detection to hold: {webp_dets}")
    rows["mixed"] = {"files": len(files), "detections": dets, "webp_detections": webp_dets}
    log(f"mixed directory ({', '.join(MIXED_FORMATS)}, webp): {len(files)} files, {dets} "
        f"detections ({webp_dets} on the WebPs), bit for bit those of the same pixels as arrays")
    # 8. NVDEC
    rows["nvdec"] = _nvdec_probe()
    log(f"NVDEC probe: libnvcuvid.so.1 {rows['nvdec']['libnvcuvid.so.1']}; headers "
        f"{rows['nvdec']['headers']}")
    rows["launches"] = total
    rows["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 26: {rows['phase_s']:.1f} s; launches {total}")
    log(f"phase 26 rows: {json.dumps(rows, default=float)}")
    return total, rows


# which paths run each kernel (its launches must be counted on each); the
# first is the kernel's own main path
KERNEL_PATHS = {"deform_fwd": ("serving", "training", "augmented training",
                               "ablation family", "serving entry points", "from disk",
                               "facade", "reference weights", "host augmentation",
                               "callbacks and drawing", "tracking", "auto_annotate",
                               "helpers", "video sources", "K1 variant A/B"),
                "deform_bwd": ("training", "augmented training", "ablation family",
                               "from disk", "facade", "reference weights",
                               "host augmentation", "callbacks and drawing"),
                "deform_fwd_simt": ("DCN A/B", "K1 variant A/B"),
                "deform_bwd_simt": ("DCN A/B",),
                "fused_augment": ("augmented training", "from disk", "facade",
                                  "reference weights", "K3 A/B"),
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
        reference, reference_rows = phase_reference_weights(Path(tmp))
        torch.cuda.empty_cache()
        host, host_rows = phase_host_augmentation(Path(tmp))
        torch.cuda.empty_cache()
        plots, plot_rows = phase_plots(Path(tmp))
        torch.cuda.empty_cache()
        seg_pose, seg_pose_rows = phase_seg_pose(Path(tmp))
        torch.cuda.empty_cache()
        zoo, zoo_rows = phase_classify_and_zoo(Path(tmp))
        torch.cuda.empty_cache()
        tracking, tracking_rows, pan = phase_tracking(Path(tmp))
        torch.cuda.empty_cache()
        rtdetr, rtdetr_rows = phase_rtdetr(Path(tmp))
        torch.cuda.empty_cache()
        sam, annotate, sam_rows = phase_sam(Path(tmp))
        torch.cuda.empty_cache()
        helpers, helper_rows = phase_helpers(Path(tmp))
        torch.cuda.empty_cache()
        video, video_rows = phase_video(Path(tmp), pan, disk_rows["decode"])
        del pan
    torch.cuda.empty_cache()
    ab_launches, ab_rows, hopper_rows, plan_rows = phase_variant_ab()
    paths = {"serving": serving, "training": training, "augmented training": augmented,
             "ablation family": ablation, "serving entry points": entry, "from disk": disk,
             "facade": facade, "reference weights": reference, "host augmentation": host,
             "callbacks and drawing": plots, "segment and pose": seg_pose,
             "classify and zoo": zoo, "tracking": tracking, "RT-DETR": rtdetr,
             "SAM": sam, "auto_annotate": annotate, "helpers": helpers,
             "video sources": video, "DCN A/B": dcn_ab,
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
        # no kernel is on the segment and pose path: its count, 0, recorded
        k["segment_and_pose_launches"] = seg_pose[k["name"]]
        # nor on the classify and zoo path
        k["classify_and_zoo_launches"] = zoo[k["name"]]
        # the tracking path runs K1 once per forward and no other kernel
        k["tracking_launches"] = tracking[k["name"]]
        # no kernel is on the RT-DETR path: its count, 0, recorded
        k["rtdetr_launches"] = rtdetr[k["name"]]
        # nor on the SAM path; auto_annotate's detector runs K1 once a forward
        k["sam_launches"] = sam[k["name"]]
        k["auto_annotate_launches"] = annotate[k["name"]]
        # the helpers' ensemble, counts, profile and trace run K1 only
        k["helpers_launches"] = helpers[k["name"]]
        # video sources: the flagship's forwards over frames, K1 only
        k["video_launches"] = video[k["name"]]
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
            k["reference_weights"] = reference_rows
        if k["name"] == "deform_bwd":
            k["reference_weights"] = {"train_step": reference_rows["train_step"]}
        if k["name"] in ("deform_fwd", "deform_bwd"):
            k["host_augmentation"] = host_rows
            k["callbacks_and_drawing"] = plot_rows
        if k["name"] == "deform_fwd":
            k["tracking"] = tracking_rows
            k["helpers"] = helper_rows
            k["video"] = video_rows
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
