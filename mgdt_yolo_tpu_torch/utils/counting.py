"""Counting over a folder of labelled images, the paper's metrics: the
counterpart of the JAX package's `mgdt_yolo_tpu/utils/counting.py`.

* `cal_model_count_error`: per class, the count MAE, MSE and MAPE over the
  images of a directory (`utils.metrics.counting_errors`; images with no
  ground truth of a class are left out of its MAPE);
* `cal_counting_metrics`: per class, TP / FP / FN at IoU > 0.5 by greedy
  matching and the count R^2 (`utils.metrics.counting_agreement`).

Both take a `YOLO` facade and a YOLO-format directory (`.../images/...`
beside `.../labels/...`), predict over it with `YOLO.predict(img_dir)` and
read each image's ground truth through `data.dataset.img2label_path`.

    python -m mgdt_yolo_tpu_torch.utils.counting MODEL IMG_DIR [--metrics]
        [--conf 0.25] [--imgsz 640] [--device cpu]
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from .metrics import counting_agreement, counting_errors

LOGGER = logging.getLogger(__name__)


def _gt_from_label_file(label_path: Path, shape) -> Dict:
    """A YOLO label file's boxes in the image's pixels (xyxy) and classes."""
    h, w = shape[:2]
    boxes, cls = [], []
    if label_path.is_file():
        for line in label_path.read_text().splitlines():
            parts = line.split()
            if len(parts) >= 5:
                c, cx, cy, bw, bh = [float(v) for v in parts[:5]]
                boxes.append([(cx - bw / 2) * w, (cy - bh / 2) * h,
                              (cx + bw / 2) * w, (cy + bh / 2) * h])
                cls.append(c)
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "cls": np.asarray(cls, np.float32)}


def _run_model(model, img_dir: str, conf: float, imgsz: int):
    """Predict over a directory: per image, its detection rows (n, 6) and
    its ground truth (boxes, classes); each image's two counts are logged."""
    from ..data.dataset import img2label_path
    results = model.predict(img_dir, conf=conf, imgsz=imgsz)
    preds, gts = [], []
    for r in results:
        preds.append(np.asarray(r.boxes.data, np.float32).reshape(-1, 6))
        gt = _gt_from_label_file(Path(img2label_path(r.path)), r.orig_shape)
        gts.append((gt["boxes"], gt["cls"]))
        LOGGER.info(f"{r.path}: {len(r)} detections, {len(gt['cls'])} labelled")
    return preds, gts


def cal_model_count_error(model, img_dir: str, classes: Sequence[int] | None = None,
                          conf: float = 0.25, imgsz: int = 640) -> Dict:
    """Per-class count MAE / MSE / MAPE over a directory of images and labels."""
    preds, gts = _run_model(model, img_dir, conf, imgsz)
    classes = list(classes) if classes is not None else list(range(model.model.nc))
    pred_counts = [{c: int((p[:, 5] == c).sum()) for c in classes} for p in preds]
    gt_counts = [{c: int((g[1] == c).sum()) for c in classes} for g in gts]
    errors = counting_errors(pred_counts, gt_counts, classes)
    for c, e in errors.items():
        LOGGER.info(f"class {c}: MAE {e['mae']:.3f}  MSE {e['mse']:.3f}  "
                    f"MAPE {e['mape']:.2f}%")
    return errors


def cal_counting_metrics(model, img_dir: str, classes: Sequence[int] | None = None,
                         conf: float = 0.25, imgsz: int = 640,
                         iou_thr: float = 0.5) -> Dict:
    """Per-class TP / FP / FN at IoU > `iou_thr` and the count R^2 over a
    directory."""
    preds, gts = _run_model(model, img_dir, conf, imgsz)
    classes = list(classes) if classes is not None else list(range(model.model.nc))
    stats, r2 = counting_agreement(preds, gts, classes, iou_thr)
    for c in classes:
        s = stats[c]
        LOGGER.info(f"class {c}: TP {s['tp']}  FP {s['fp']}  FN {s['fn']}  "
                    f"count R^2 {r2[c]:.4f}")
    return {"stats": stats, "r2": r2}


def main(argv: List[str] | None = None):
    """The command line: count over IMG_DIR with MODEL (a config name or an
    npz archive); `--metrics` adds TP / FP / FN and R^2."""
    import argparse

    from .settings import set_logging
    ap = argparse.ArgumentParser(description="counting evaluation over a folder")
    ap.add_argument("model", help="model YAML name or npz archive")
    ap.add_argument("img_dir", help="directory of val images (YOLO layout)")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--device", default=None, help="cpu, 0 or cuda:0 (default: CUDA)")
    ap.add_argument("--metrics", action="store_true",
                    help="also compute TP/FP/FN + R^2 agreement metrics")
    args = ap.parse_args(argv)
    set_logging()
    from ..engine.model import YOLO
    model = YOLO(args.model, device=args.device)
    out = {"errors": cal_model_count_error(model, args.img_dir, conf=args.conf,
                                           imgsz=args.imgsz)}
    if args.metrics:
        out["agreement"] = cal_counting_metrics(model, args.img_dir, conf=args.conf,
                                                imgsz=args.imgsz)
    return out


if __name__ == "__main__":  # run as the package's module, whose logger the CLI configures
    from mgdt_yolo_tpu_torch.utils.counting import main as _main
    _main()
