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
BGR images and lists of them; image and video files, directories and
globs; HTTP Motion JPEG streams; screenshots. The helper thread that
letterboxes takes each batch's items from the source as they come and
decodes them together (`native`: nvJPEG for JPEG images and Motion JPEG
frames), one batch ahead, so a long video or an endless stream never sits
in memory whole; `Results.path` is the file's path (`stream_<url>`,
`screen_<n>`). A file the decoder cannot read is logged and skipped; a
video ends at its first frame that cannot be read. Under
`<project>/<name>` (runs/detect/predict by default), `save` writes
`<stem>.jpg` of `Results.plot()` (for each video, or stream, `<stem>.mp4` of
its drawn frames at its fps: Motion JPEG where JAX's writes MPEG-4 Part 2,
each closed at the end of the source or on an exception), `save_txt`
`labels/<stem>.txt` and `save_crop` `crops/<class>/<stem>.jpg` of every
detection (`utils.plotting.save_one_box`), as the JAX predictor does. The
hooks `on_predict_start`, `on_predict_postprocess_end` (each batch, with
`batch_items` its source items: a video frame's carry `is_video`, `fps`
and `frame_idx`, which key the trackers) and `on_predict_end` fire as in
JAX.

`predict` is the fixed-size path beside it: an NHWC RGB batch already at the
model's size, with the serving settings of the JAX benchmark (`bench.py`).
`load_source(source)` reads a whole source into a list of its items, as
JAX's does.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..cfg import check_cfg_types, check_dict_alignment
from ..cfg.default import CFG_DEFAULTS
from ..data.augment import letterbox
from ..data.loaders import load_inference_source
from ..device import names_device, parse_device
from ..native.video import VideoWriter
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


def load_source(source) -> List[Dict]:
    """Every item of a predict source, read: a list of {img (BGR), path,
    frame_idx, is_video} dicts (a video frame's with its `fps`), as the JAX
    package's `load_source` lists its loader's items
    (`data.loaders.load_inference_source`: arrays, images, videos, streams,
    screenshots). A file the decoder cannot read is logged and skipped."""
    return list(load_inference_source(source))


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


def check_images(chunk: List[Dict]) -> List[Dict]:
    """`chunk`, after checking that each image is (h, w, 3) uint8 BGR."""
    for c in chunk:
        im = c["img"]
        if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
            raise ValueError(f"an image must be (h, w, 3) uint8 BGR, got {im.shape} {im.dtype}")
    return chunk


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

    def _prepare(self, src, entries, batch: int):
        """Host side of one batch: the source's next `batch` items decoded,
        letterboxed, and in pinned memory on the GPU so the upload is an
        asynchronous copy; None once the source has none left."""
        t0 = time.perf_counter()
        chunk = list(islice(entries, batch))
        if not chunk:
            return None
        chunk = check_images(src.decode(chunk))
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
        src = load_inference_source(source)
        entries = src.entries()
        self.dataset_bs = batch
        self._video_writers: Dict[str, VideoWriter] = {}
        self.run_callbacks("on_predict_start")
        try:
            with ThreadPoolExecutor(1, thread_name_prefix="mgdt-letterbox") as pool:
                pending = pool.submit(self._prepare, src, entries, batch)
                while True:
                    prepared = pending.result()
                    if prepared is None:
                        break
                    chunk, meta, x, pre_ms = prepared
                    pending = pool.submit(self._prepare, src, entries, batch)
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
                    for r, c in zip(self.results, chunk):
                        if a.save or a.save_txt or a.save_crop:
                            self._save(r, c)
                        yield r
        finally:
            for vw in self._video_writers.values():
                vw.release()
            self._video_writers = {}
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

    def _save(self, r: Results, item: Optional[Dict] = None):
        """What `save`, `save_txt` and `save_crop` write of one result (its
        source item tells a video's frame: drawn into the video's writer)."""
        a = self.args
        save_dir = Path(a.project or "runs/detect") / (a.name or "predict")
        save_dir.mkdir(parents=True, exist_ok=True)
        stem = Path(r.path).stem
        if a.save and item and item.get("is_video"):
            vw = self._video_writers.get(r.path)
            if vw is None:
                h, w = r.orig_img.shape[:2]
                vw = self._video_writers[r.path] = VideoWriter(
                    save_dir / f"{stem}.mp4", item.get("fps", 30), (w, h))
            vw.write(r.plot())
        elif a.save:
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
