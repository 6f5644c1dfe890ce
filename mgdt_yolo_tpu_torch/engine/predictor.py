"""Prediction: images of any size in, detections in their own pixels out.

The counterpart of the JAX package's `mgdt_yolo_tpu/engine/predictor.py`.
`DetectionPredictor` letterboxes BGR uint8 images of any size to the
model's square (`data.augment.letterbox`, cv2's resize without cv2), runs
the eval forward (or test-time augmentation, `augment=True`) and NMS on the
model's device, and maps the boxes back to each image (`det_to_original`),
wrapped as `engine.results.Results`. Its settings are the JAX
configuration's keys (`cfg.default.CFG_DEFAULTS`): `conf` (0.25 when
unset), `iou`, `max_det`, `agnostic_nms`, `imgsz`, `augment`, `half`
(bf16), `save_txt` with `save_conf`, `project` and `name`, and `device`
(the model's; CUDA by default). Serving folds Conv+BN (`DetectionModel.fuse`,
in place). The predictor's `save` default is False, as the reference's
Python API has it.

Sources are the JAX loader's (`data.loaders.load_inference_source`): numpy
BGR images and lists of them, and image files, directories and globs,
decoded by the port's decoder (`native`) on the helper thread that
letterboxes, one batch ahead; `Results.path` is then the file's path. A
file the decoder cannot read is logged and skipped. Under
`<project>/<name>` (runs/detect/predict by default), `save` writes
`<stem>.jpg` of `Results.plot()`, `save_txt` `labels/<stem>.txt` and
`save_crop` `crops/<class>/<stem>.jpg` of every detection
(`utils.plotting.save_one_box`), as the JAX predictor does. The hooks
`on_predict_start`, `on_predict_postprocess_end` (each batch, with
`batch_items` its source items) and `on_predict_end` fire as in JAX. Not
ported, and refused: video, stream and screenshot sources, so also the
writing of video, and the `bmp`, `tif`, `tiff` and `webp` formats
(ROADMAP queue 1, item 4).

`predict` is the fixed-size path beside it: an NHWC RGB batch already at the
model's size, with the serving settings of the JAX benchmark (`bench.py`).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..cfg import check_cfg_types, check_dict_alignment
from ..cfg.default import CFG_DEFAULTS
from ..data.augment import letterbox
from ..data.loaders import LoadImagesAndVideos, load_inference_source
from ..device import names_device, parse_device
from ..ops.boxes import scale_boxes
from ..ops.nms import non_max_suppression
from ..utils.callbacks import CallbackMixin
from ..utils import draw
from ..utils.plotting import save_one_box
from .results import Results

CONF, IOU, MAX_DET, PRE_TOPK, BLOCK = 0.25, 0.7, 300, 1024, 256
PREDICT_DEFAULTS = {**CFG_DEFAULTS, "save": False}


@torch.no_grad()
def predict(model, images):
    """Detect objects in an NHWC RGB batch (uint8, or float in [0, 1]).

    `images` is a numpy array or tensor (B, H, W, 3) with H and W multiples
    of the model's largest stride. Runs on the model's device. Returns
    (det (B, MAX_DET, 6) [x1, y1, x2, y2, conf, cls] zero-padded,
    counts (B,) int32).
    """
    x = images if torch.is_tensor(images) else torch.from_numpy(np.ascontiguousarray(images))
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(x.shape)}")
    x = x.to(model.device)
    if not x.is_floating_point():
        x = x.float() / 255.0
    decoded, _ = model(x)
    return non_max_suppression(decoded, conf_thres=CONF, iou_thres=IOU,
                               max_det=MAX_DET, pre_topk=PRE_TOPK, block=BLOCK)


def letterbox_batch(imgs: List[np.ndarray], imgsz: int):
    """Letterbox BGR images into one RGB uint8 batch (b, imgsz, imgsz, 3)
    and each image's (ori_shape, ratio_pad), for the predictor and the
    server alike."""
    out, meta = [], []
    for im in imgs:
        lb, ratio, pad = letterbox(im, (imgsz, imgsz), scaleup=True)
        out.append(lb[..., ::-1])  # BGR -> RGB; scaled on the device
        meta.append((im.shape[:2], (ratio, pad)))
    return np.stack(out), meta


def det_to_original(det: np.ndarray, imgsz: int, meta) -> np.ndarray:
    """One image's [x1, y1, x2, y2, ...] rows from the letterboxed square
    back to the original image's pixels (in place; returns det)."""
    ori_shape, ratio_pad = meta
    if len(det):
        det[:, :4] = scale_boxes((imgsz, imgsz), det[:, :4], ori_shape, ratio_pad)
    return det


def infer(model, x: torch.Tensor, conf: float, iou: float, max_det: int,
          agnostic: bool = False, augment: bool = False):
    """The device step of a uint8 NHWC batch: scale by 1/255, the eval
    forward (or `predict_augment`), NMS. Returns (det, counts) on the device.
    As JAX's predictor and server, the NMS is given no class count, so it
    takes every channel after the box as a class score: on a segment or
    pose model the mask coefficients or decoded keypoints rank as classes
    too (the reference's behaviour, kept)."""
    x = x.float() / 255.0
    decoded, _ = model.predict_augment(x) if augment else model(x)
    return non_max_suppression(decoded, conf_thres=conf, iou_thres=iou, max_det=max_det,
                               agnostic=agnostic)


def load_source(source) -> List[Dict]:
    """A source as a list of {path} and, for images in memory, {img (BGR
    uint8 HWC)}: numpy images (named `array<i>.jpg`, as the JAX loader
    names them) are taken as they are, files are listed to be decoded a
    batch at a time (`decode_items`)."""
    src = load_inference_source(source)
    if isinstance(src, LoadImagesAndVideos):
        return [{"path": f} for f in src.files]
    out = []
    for it in src:
        im = it["img"]
        if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
            raise ValueError(f"an image must be (h, w, 3) uint8 BGR, got {im.shape} {im.dtype}")
        out.append({"img": im, "path": it["path"]})
    return out


def decode_items(chunk: List[Dict]) -> List[Dict]:
    """`chunk` with every file decoded (together, on the decoder's
    threads); a file the decoder cannot read is logged and dropped."""
    files = [c["path"] for c in chunk if "img" not in c]
    if not files:
        return chunk
    decoded = {it["path"]: it for it in LoadImagesAndVideos.decode_batch(files)}
    return [c if "img" in c else decoded[c["path"]] for c in chunk
            if "img" in c or c["path"] in decoded]


class BasePredictor(CallbackMixin):
    """Streams a source through a model in batches; see the module's text.

    `DetectionPredictor(overrides={...})`, then `setup_model(model)`, then
    `predictor(source, stream=False, batch=1)`: a list of `Results` (a
    generator with `stream=True`), one per image, in order.
    """

    def __init__(self, args: Optional[Dict] = None, overrides: Optional[Dict] = None):
        merged = dict(PREDICT_DEFAULTS)
        for extra in (args, overrides):
            if extra:
                check_dict_alignment(CFG_DEFAULTS, extra)
                merged.update(extra)
        check_cfg_types(merged)
        self.args = SimpleNamespace(**merged)
        self.init_callbacks()
        self.device = parse_device(self.args.device)
        self.model = None
        self.results: List[Results] = []

    def setup_model(self, model):
        """Serve `model` (on the `device` key's device, in place): eval
        mode, Conv+BN folded, bf16 with `half`."""
        if not names_device(self.device, model.device):
            raise ValueError(f"the model is on {model.device}, the predictor's device is "
                             f"{self.device}")
        model.eval().fuse()
        if self.args.half:
            model.to(torch.bfloat16)
        self.model = model
        return self

    def preprocess(self, imgs: List[np.ndarray]):
        return letterbox_batch(imgs, self.args.imgsz)

    def _prepare(self, chunk):
        """Host side of one batch: decode its files, letterbox, and pinned
        memory on the GPU so the upload is an asynchronous copy."""
        t0 = time.perf_counter()
        chunk = decode_items(chunk)
        if not chunk:
            return chunk, [], None, (time.perf_counter() - t0) * 1e3
        x, meta = self.preprocess([c["img"] for c in chunk])
        x = torch.from_numpy(x)
        if self.device.type == "cuda":
            x = x.pin_memory()
        return chunk, meta, x, (time.perf_counter() - t0) * 1e3

    @torch.no_grad()
    def stream_inference(self, source, batch: int = 1) -> Iterator[Results]:
        """Results one image at a time, `batch` images a device step. A
        helper thread letterboxes batch i + 1 while batch i runs; `speed`
        holds each image's share of its batch's preprocess (decode and
        letterbox) and inference (upload, forward, NMS, download) in ms."""
        if self.model is None:
            raise RuntimeError("call setup_model(model) first")
        a = self.args
        items = load_source(source)
        chunks = [items[s:s + batch] for s in range(0, len(items), batch)]
        self.dataset_bs = batch
        self.run_callbacks("on_predict_start")
        with ThreadPoolExecutor(1, thread_name_prefix="mgdt-letterbox") as pool:
            pending = pool.submit(self._prepare, chunks[0]) if chunks else None
            for i in range(len(chunks)):
                chunk, meta, x, pre_ms = pending.result()
                if i + 1 < len(chunks):
                    pending = pool.submit(self._prepare, chunks[i + 1])
                if not chunk:  # every file of the batch was unreadable
                    continue
                t0 = time.perf_counter()
                dets = self.detect(x.to(self.device, non_blocking=True), chunk, meta)
                inf_ms = (time.perf_counter() - t0) * 1e3
                speed = {"preprocess": pre_ms / len(chunk), "inference": inf_ms / len(chunk),
                         "postprocess": 0.0}
                self.results = [Results(c["img"], c["path"], self.model.names, det,
                                        speed=dict(speed)) for c, det in zip(chunk, dets)]
                self.batch_items = chunk
                self.run_callbacks("on_predict_postprocess_end")
                for r in self.results:
                    if a.save or a.save_txt or a.save_crop:
                        self._save(r)
                    yield r
        self.run_callbacks("on_predict_end")

    def detect(self, x: torch.Tensor, chunk: List[Dict], meta) -> List[np.ndarray]:
        """Each image's detections [x1, y1, x2, y2, conf, cls] in its own
        pixels, from the letterboxed uint8 batch `x` on the device: the
        forward (or TTA), NMS and the way back through the letterbox."""
        a = self.args
        det, counts = infer(self.model, x, a.conf or CONF, a.iou, a.max_det, a.agnostic_nms,
                            a.augment)
        det, counts = det.float().cpu().numpy(), counts.cpu().numpy()
        return [det_to_original(det[j][:int(counts[j])].copy(), a.imgsz, meta[j])
                for j in range(len(chunk))]

    def _save(self, r: Results):
        """What `save`, `save_txt` and `save_crop` write of one result."""
        a = self.args
        save_dir = Path(a.project or "runs/detect") / (a.name or "predict")
        save_dir.mkdir(parents=True, exist_ok=True)
        stem = Path(r.path).stem
        if a.save:
            draw.imwrite(save_dir / f"{stem}.jpg", r.plot())
        if a.save_txt:
            r.save_txt(save_dir / "labels" / f"{stem}.txt", a.save_conf)
        if a.save_crop:
            for row in r.boxes.data:
                cname = str(r.names.get(int(row[5]), int(row[5])))
                save_one_box(row[:4], r.orig_img,  # BGR in, RGB crop, BGR file
                             file=save_dir / "crops" / cname / f"{stem}.jpg")

    def __call__(self, source, stream: bool = False, batch: int = 1):
        gen = self.stream_inference(source, batch)
        return gen if stream else list(gen)


class DetectionPredictor(BasePredictor):
    """The detect task's predictor."""
