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

Not ported, and refused: file, directory, video and stream sources, which
need an image decoder on the card's host (ROADMAP queue 1, item 4), and
`save` and `save_crop`, which draw (item 5); the JAX predictor's callbacks.

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

from ..cfg.default import CFG_DEFAULTS
from ..data.augment import letterbox
from ..device import names_device, resolve_device
from ..ops.boxes import scale_boxes
from ..ops.nms import non_max_suppression
from .results import Results

CONF, IOU, MAX_DET, PRE_TOPK, BLOCK = 0.25, 0.7, 300, 1024, 256
PREDICT_DEFAULTS = {**CFG_DEFAULTS, "save": False}
NO_DECODER = ("only numpy images (BGR uint8, (h, w, 3)) and lists of them are taken: file, "
              "directory, video and stream sources need an image decoder on the card's host, "
              "which is not ported yet (ROADMAP queue 1, item 4)")
NO_DRAWING = "{} draws, and drawing without cv2 is not ported yet (ROADMAP queue 1, item 5)"


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
    forward (or `predict_augment`), NMS. Returns (det, counts) on the device."""
    x = x.float() / 255.0
    decoded, _ = model.predict_augment(x) if augment else model(x)
    return non_max_suppression(decoded, conf_thres=conf, iou_thres=iou, max_det=max_det,
                               agnostic=agnostic, nc=model.nc)


def load_source(source) -> List[Dict]:
    """A source as a list of {img (BGR uint8 HWC), path}: a numpy image or a
    list or tuple of them (named `array<i>.jpg`, as the JAX loader names
    them). Raises for any other source."""
    items = source if isinstance(source, (list, tuple)) else [source]
    out = []
    for i, im in enumerate(items):
        if not isinstance(im, np.ndarray):
            raise NotImplementedError(f"{type(im).__name__} source: {NO_DECODER}")
        if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
            raise ValueError(f"an image must be (h, w, 3) uint8 BGR, got {im.shape} {im.dtype}")
        out.append({"img": im, "path": f"array{i}.jpg"})
    return out


def _device_of(value) -> torch.device:
    """The `device` key's device: None (CUDA), "cpu", "cuda:0", 0 or "0"."""
    if value is not None and str(value).strip().isdigit():
        value = int(str(value).strip())
    return resolve_device(value)


class BasePredictor:
    """Streams a source through a model in batches; see the module's text.

    `DetectionPredictor(overrides={...})`, then `setup_model(model)`, then
    `predictor(source, stream=False, batch=1)`: a list of `Results` (a
    generator with `stream=True`), one per image, in order.
    """

    def __init__(self, args: Optional[Dict] = None, overrides: Optional[Dict] = None):
        from .trainer import check_cfg_types, check_dict_alignment
        merged = dict(PREDICT_DEFAULTS)
        for extra in (args, overrides):
            if extra:
                check_dict_alignment(CFG_DEFAULTS, extra)
                merged.update(extra)
        check_cfg_types(merged)
        for key in ("save", "save_crop"):
            if merged[key]:
                raise NotImplementedError(NO_DRAWING.format(key))
        self.args = SimpleNamespace(**merged)
        self.device = _device_of(self.args.device)
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
        """Host side of one batch: letterbox, and pinned memory on the GPU
        so the upload is an asynchronous copy."""
        t0 = time.perf_counter()
        x, meta = self.preprocess([c["img"] for c in chunk])
        x = torch.from_numpy(x)
        if self.device.type == "cuda":
            x = x.pin_memory()
        return chunk, meta, x, (time.perf_counter() - t0) * 1e3

    @torch.no_grad()
    def stream_inference(self, source, batch: int = 1) -> Iterator[Results]:
        """Results one image at a time, `batch` images a device step. A
        helper thread letterboxes batch i + 1 while batch i runs; `speed`
        holds each image's share of its batch's preprocess (the letterbox)
        and inference (upload, forward, NMS, download) in ms."""
        if self.model is None:
            raise RuntimeError("call setup_model(model) first")
        a = self.args
        items = load_source(source)
        chunks = [items[s:s + batch] for s in range(0, len(items), batch)]
        with ThreadPoolExecutor(1, thread_name_prefix="mgdt-letterbox") as pool:
            pending = pool.submit(self._prepare, chunks[0]) if chunks else None
            for i in range(len(chunks)):
                chunk, meta, x, pre_ms = pending.result()
                if i + 1 < len(chunks):
                    pending = pool.submit(self._prepare, chunks[i + 1])
                t0 = time.perf_counter()
                det, counts = infer(self.model, x.to(self.device, non_blocking=True),
                                    a.conf or CONF, a.iou, a.max_det, a.agnostic_nms,
                                    a.augment)
                det, counts = det.float().cpu().numpy(), counts.cpu().numpy()
                inf_ms = (time.perf_counter() - t0) * 1e3
                speed = {"preprocess": pre_ms / len(chunk), "inference": inf_ms / len(chunk),
                         "postprocess": 0.0}
                self.results = [
                    Results(c["img"], c["path"], self.model.names,
                            det_to_original(det[j][:int(counts[j])].copy(), a.imgsz, meta[j]),
                            speed=dict(speed))
                    for j, c in enumerate(chunk)]
                for r in self.results:
                    if a.save_txt:
                        self._save_txt(r)
                    yield r

    def _save_txt(self, r: Results):
        save_dir = Path(self.args.project or "runs/detect") / (self.args.name or "predict")
        save_dir.mkdir(parents=True, exist_ok=True)
        r.save_txt(save_dir / "labels" / f"{Path(r.path).stem}.txt", self.args.save_conf)

    def __call__(self, source, stream: bool = False, batch: int = 1):
        gen = self.stream_inference(source, batch)
        return gen if stream else list(gen)


class DetectionPredictor(BasePredictor):
    """The detect task's predictor."""
