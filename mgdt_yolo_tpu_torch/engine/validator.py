"""Validation: the eval forward and the val NMS on the device, mAP and the
counting metrics on the host; the counterpart of `DetectionValidator` in
`mgdt_yolo_tpu/engine/validator.py`.

The model runs unfused in `eval()` mode, in float32, or under bf16 autocast
with `half=True` on any device, as the JAX validator casts to bf16 only
under `half`; the `Trainer` validates with `half` set to its own bf16 `amp`,
as JAX's in-training validation runs under the trainer's dtype. Then NMS with the val protocol: conf
`args["conf"]` (0.001 when unset), IoU `args["iou"]`, every class of an
anchor a candidate (`multi_label`), classes kept apart unless
`args["agnostic_nms"]`, a 4096-deep candidate pool resolved in
blocks of 1024, `max_det` survivors. Detections and labels go back through
each image's letterbox (`scale_boxes` with its `ratio_pad`) and feed
`match_predictions`, `DetMetrics`, `ConfusionMatrix` and
`counting_agreement`, as in the JAX validator. Called without a loader,
it validates on the `val` split of `args["data"]` (a dataset YAML or
directory; the JAX trainer's synthetic validation set when it is None),
as the JAX validator does standalone; with `args["rect"]` that loader
plans rectangular batches (ordered by aspect, each letterboxed to its own
multiple of the model's largest stride, `data.build.DataLoader`).

With `args["save_json"]`, every image's detections become COCO json rows
(`pred_to_json`: xywh from the top-left corner, a numeric file stem as an
int `image_id`, the category through `class_map`, COCO's 91 ids for a
`val2017` split of a `coco` dataset), written to
`<args["save_dir"]>/predictions.json` (the working directory without
one); COCOeval refreshes the mAP only where pycocotools imports and the
split's annotations exist, as in JAX (`eval_json`).

With `plots` and a `save_dir`, the first batch is drawn with its labels
and its detections (`val_batch0_labels.jpg`, `val_batch0_pred.jpg`) and
the confusion matrix is written (`confusion_matrix.png`); a drawing
failure is logged and validation goes on, as in JAX. The hooks
`on_val_start` and `on_val_end` fire as in JAX.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..cfg.default import TRAIN_DEFAULTS
from ..ops.boxes import scale_boxes
from ..ops.nms import non_max_suppression
from ..utils.callbacks import CallbackMixin
from ..utils.metrics import ConfusionMatrix, DetMetrics, counting_agreement, match_predictions

LOGGER = logging.getLogger(__name__)
VAL_PRE_TOPK, VAL_BLOCK = 4096, 1024


def coco80_to_coco91_class():
    """80-index -> 91-index COCO category ids: the val2017 annotations skip
    11 removed categories."""
    return [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
            20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
            39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
            56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
            76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90]


class BaseValidator(CallbackMixin):
    """What a validator holds, as JAX's `BaseValidator`
    (`engine/validator.py:29`): `args` over `cfg.default.TRAIN_DEFAULTS`
    (with `half` False), a default `dataloader`, and the callbacks."""

    def __init__(self, args: Optional[Dict] = None, dataloader=None):
        self.args = {**TRAIN_DEFAULTS, "half": False, **(args or {})}
        self.dataloader = dataloader
        self.init_callbacks()


class DetectionValidator(BaseValidator):
    """`validator(model, loader)` -> {precision, recall, map50, map, fitness,
    speed_ms_per_image}. `args` replace keys of `cfg.default.TRAIN_DEFAULTS`
    (`conf`, `iou`, `max_det`, `agnostic_nms`, `rect`, `save_json`), and
    may set `half` (bf16), `plots` and `save_dir`. `model` may be an
    `nn.tasks.Ensemble`."""

    def __init__(self, args: Optional[Dict] = None, dataloader=None):
        super().__init__(args, dataloader)
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.is_coco = False
        self.class_map = list(range(1000))
        self.anno_json = None
        self.jdict = []

    def pred_to_json(self, predn: np.ndarray, filename) -> None:
        """Append one image's detections (rows x1, y1, x2, y2, conf, cls in
        its own pixels) as COCO json rows, as the JAX `pred_to_json` does."""
        stem = Path(str(filename)).stem
        image_id = int(stem) if stem.isnumeric() else stem
        box = predn[:, :4].astype(np.float64)
        box = np.stack([(box[:, 0] + box[:, 2]) / 2 - (box[:, 2] - box[:, 0]) / 2,
                        (box[:, 1] + box[:, 3]) / 2 - (box[:, 3] - box[:, 1]) / 2,
                        box[:, 2] - box[:, 0], box[:, 3] - box[:, 1]], axis=1)
        for p, b in zip(predn.tolist(), box.tolist()):
            self.jdict.append({"image_id": image_id, "category_id": self.class_map[int(p[5])],
                               "bbox": [round(x, 3) for x in b], "score": round(p[4], 5)})

    def eval_json(self, results: Dict[str, float]) -> Dict[str, float]:
        """Write predictions.json under `save_dir` and, for a COCO split whose
        annotations exist, take mAP50-95 and mAP50 from COCOeval where
        pycocotools imports (a warning otherwise, as in JAX)."""
        if not (self.args.get("save_json") and self.jdict):
            return results
        save_dir = Path(str(self.args.get("save_dir") or "."))
        save_dir.mkdir(parents=True, exist_ok=True)
        pred_json = save_dir / "predictions.json"
        with open(pred_json, "w") as f:
            json.dump(self.jdict, f)
        LOGGER.info(f"saved {len(self.jdict)} COCO-format predictions to {pred_json}")
        self.pred_json = pred_json
        if self.is_coco and self.anno_json and Path(self.anno_json).is_file():
            try:
                from pycocotools.coco import COCO
                from pycocotools.cocoeval import COCOeval
                anno = COCO(str(self.anno_json))
                ev = COCOeval(anno, anno.loadRes(str(pred_json)), "bbox")
                ev.evaluate()
                ev.accumulate()
                ev.summarize()
                results["map"], results["map50"] = ev.stats[:2]
            except ImportError:
                LOGGER.warning("pycocotools not installed: predictions.json written, COCOeval "
                               "skipped")
            except Exception as e:
                LOGGER.warning(f"pycocotools unable to run: {e}")
        return results

    def _coco_split(self, loader) -> None:
        """The JAX validator's COCO sniff: a `coco` ... `val2017` data
        string or image path gets the 91-id class map and the split's
        annotation file."""
        data_str = str(self.args.get("data") or "")
        img_path = str(getattr(getattr(loader, "dataset", None), "img_path", "") or "")
        self.is_coco = "coco" in (data_str + img_path) and "val2017" in (data_str + img_path)
        self.class_map = coco80_to_coco91_class() if self.is_coco else list(range(1000))
        self.anno_json = None
        if self.is_coco:
            parents = Path(img_path).resolve().parents if img_path else []
            root = parents[1] if len(parents) > 1 else None
            self.anno_json = root / "annotations/instances_val2017.json" if root else None

    @torch.no_grad()
    def infer(self, model, img: torch.Tensor):
        """Detections (B, max_det, 6) and counts (B,) of one uint8 batch."""
        a = self.args
        dev = model.device
        x = img.to(dev)
        if not x.is_floating_point():
            x = x.float() / 255.0
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bool(a["half"])):
            decoded, _ = model(x)
        return non_max_suppression(decoded.float(), conf_thres=a["conf"] or 0.001,
                                   iou_thres=a["iou"], max_det=a["max_det"],
                                   multi_label=True, agnostic=a["agnostic_nms"],
                                   pre_topk=VAL_PRE_TOPK, block=VAL_BLOCK, nc=model.nc)

    def __call__(self, model, loader=None) -> Dict[str, float]:
        """Validate `model` (put in `eval()` mode) over `loader`, a
        validation `DataLoader` (`train=False`); by default the `val` split
        of `args["data"]` (`engine.trainer.build_loader`), unless the
        validator was built with a `dataloader`."""
        loader = loader if loader is not None else self.dataloader
        if loader is None:
            from .trainer import build_loader
            loader = build_loader(self.args, False, model)
        model.eval()
        metrics = DetMetrics()
        cm = ConfusionMatrix(model.nc)
        per_image_preds, per_image_gts, paths = [], [], []
        self.jdict, self.batch_shapes = [], []
        self._coco_split(loader)
        save_json = bool(self.args.get("save_json"))
        plots = bool(self.args.get("plots")) and self.args.get("save_dir") is not None
        self.run_callbacks("on_val_start")
        t0 = time.time()
        for bi, batch in enumerate(loader):
            dets, counts = self.infer(model, torch.from_numpy(batch["img"]))
            dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
            if bi == 0 and plots:
                self.plot_val_batch(batch, dets, counts, model.names)
            in_shape = tuple(batch["img"].shape[1:3])  # rect: each batch its own (h, w)
            self.batch_shapes.append(in_shape)
            for j in range(len(dets)):
                det = dets[j][:int(counts[j])]
                m = batch["metas"][j]
                gt_mask = batch["mask_gt"][j]
                gt_boxes = batch["gt_bboxes"][j][gt_mask]
                gt_cls = batch["gt_labels"][j][gt_mask].astype(float)
                det_s = det.copy()
                det_s[:, :4] = scale_boxes(in_shape, det[:, :4], m["ori_shape"], m["ratio_pad"])
                gt_s = (scale_boxes(in_shape, gt_boxes.copy(), m["ori_shape"], m["ratio_pad"])
                        if len(gt_boxes) else gt_boxes)
                tp = match_predictions(det_s[:, :4], det_s[:, 5], gt_s, gt_cls, self.iouv)
                metrics.update(tp, det_s[:, 4], det_s[:, 5], gt_cls)
                if save_json:
                    self.pred_to_json(det_s, m.get("path", f"{len(per_image_preds)}"))
                cm.process_batch(det_s, gt_s, gt_cls)
                per_image_preds.append(det_s)
                per_image_gts.append((gt_s, gt_cls))
                paths.append(m.get("path", ""))
        results = metrics.process()
        self.metrics, self.confusion_matrix = metrics, cm
        if plots:
            try:
                cm.plot(save_dir=str(self.args["save_dir"]), names=model.names)
            except Exception as e:  # drawing must never end a validation
                LOGGER.warning(f"confusion-matrix plot failed: {e}")
        self.per_image_preds, self.per_image_gts = per_image_preds, per_image_gts
        self.per_image_paths = paths
        self.counting_stats, self.count_r2 = counting_agreement(
            per_image_preds, per_image_gts, list(range(model.nc)))
        results = self.eval_json(results)
        results["speed_ms_per_image"] = (time.time() - t0) / max(len(per_image_preds), 1) * 1000
        self.run_callbacks("on_val_end")
        return results

    def plot_val_batch(self, batch, dets, counts, names) -> None:
        """`val_batch0_labels.jpg` and `val_batch0_pred.jpg` under
        `save_dir`: the batch's letterboxed images with their labels and
        their detections, as JAX's `_plot_val_batch` draws them."""
        from ..utils.plotting import plot_images
        try:
            save_dir = Path(str(self.args["save_dir"]))
            imgs = batch["img"].astype(np.float32) / 255.0
            gt = [np.concatenate([batch["gt_bboxes"][j][batch["mask_gt"][j]],
                                  np.ones((int(batch["mask_gt"][j].sum()), 1)),
                                  batch["gt_labels"][j][batch["mask_gt"][j]][:, None]], 1)
                  for j in range(len(imgs))]
            plot_images(imgs, gt, names or {}, str(save_dir / "val_batch0_labels.jpg"))
            pred = [dets[j][:int(counts[j])] for j in range(len(imgs))]
            plot_images(imgs, pred, names or {}, str(save_dir / "val_batch0_pred.jpg"))
        except Exception as e:  # drawing must never end a validation
            LOGGER.warning(f"val plots failed: {e}")
