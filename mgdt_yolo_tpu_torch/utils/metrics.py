"""Evaluation metrics: mAP (101-point interpolation), confusion matrix, and the
fork's piglet-counting metrics (MAE/MSE/MAPE, TP/FP/FN@0.5, count R^2).

A copy of the JAX package's numpy-only `mgdt_yolo_tpu/utils/metrics.py`
(the port imports nothing of that package), without the confusion
matrix's matplotlib plot. Same interpolation and fitness definitions, so
the port's mAP is the JAX validator's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# numpy >= 2 names it trapezoid; older releases only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def box_iou_numpy(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    a2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (a1[:, None] + a2[None, :] - inter + eps)


def match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls,
                      iou_thresholds=None) -> np.ndarray:
    """True-positive matrix across the 10 COCO IoU thresholds.

    Mirrors DetectionValidator._process_batch (reference yolo/v8/detect/
    val.py:152-175): per threshold, greedy unique matching sorted by IoU.
    Returns (n_pred, n_thr) bool.
    """
    if iou_thresholds is None:
        iou_thresholds = np.linspace(0.5, 0.95, 10)
    n_pred = len(pred_cls)
    tp = np.zeros((n_pred, len(iou_thresholds)), bool)
    if n_pred == 0 or len(gt_cls) == 0:
        return tp
    iou = box_iou_numpy(gt_boxes, pred_boxes)
    correct_class = gt_cls[:, None] == pred_cls[None, :]
    iou = iou * correct_class
    for t, thr in enumerate(iou_thresholds):
        gi, pi = np.nonzero(iou >= thr)
        if gi.size:
            vals = iou[gi, pi]
            order = vals.argsort()[::-1]
            m = np.stack([gi, pi], 1)[order]
            m = m[np.unique(m[:, 1], return_index=True)[1]]
            m = m[np.unique(m[:, 0], return_index=True)[1]]
            tp[m[:, 1], t] = True
    return tp


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Average precision by 101-point interpolation (reference metrics.py:371-407)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def _smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter of fraction f (reference metrics.py:319-324)."""
    nf = round(len(y) * f * 2) // 2 + 1  # odd filter width
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, eps: float = 1e-16) -> Dict[str, np.ndarray]:
    """Per-class precision/recall/AP (reference metrics.py:410-498).

    Args:
        tp: (n, n_iou_thr) bool TP matrix.
        conf, pred_cls: (n,) prediction confidence / class.
        target_cls: (m,) gt classes across the whole dataset.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes, nt = np.unique(target_cls, return_counts=True)
    nc = len(classes)
    n_thr = tp.shape[1] if tp.ndim > 1 else 1
    ap = np.zeros((nc, n_thr))
    px = np.linspace(0, 1, 1000)
    p_curves = np.zeros((nc, len(px)))
    r_curves = np.zeros((nc, len(px)))
    for ci, c in enumerate(classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        p_curves[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        r_curves[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        for t in range(n_thr):
            ap[ci, t], _, _ = compute_ap(recall[:, t], precision[:, t])
    # P/R read at ONE confidence for all classes: the argmax of the
    # box-smoothed mean-F1 curve (reference metrics.py:319-324, 493-494) —
    # per-class unsmoothed argmaxes would not be comparable to the reference
    f1_curves = 2 * p_curves * r_curves / (p_curves + r_curves + eps)
    i = _smooth(f1_curves.mean(0), 0.1).argmax()
    return {"classes": classes.astype(int), "precision": p_curves[:, i],
            "recall": r_curves[:, i], "ap": ap, "nt": nt}


class DetMetrics:
    """Accumulates detection stats and produces mAP50 / mAP50-95 / fitness
    (reference metrics.py:705-717; fitness = 0.1*mAP50 + 0.9*mAP50-95,
    metrics.py:622-626)."""

    def __init__(self, names: Dict[int, str] | None = None):
        self.names = names or {}
        self._tp, self._conf, self._pcls, self._tcls = [], [], [], []
        self.results = {}

    def update(self, tp, conf, pred_cls, target_cls):
        self._tp.append(np.asarray(tp))
        self._conf.append(np.asarray(conf))
        self._pcls.append(np.asarray(pred_cls))
        self._tcls.append(np.asarray(target_cls))

    def process(self) -> Dict[str, float]:
        if not self._tp or sum(len(t) for t in self._tcls) == 0:
            self.results = {"precision": 0.0, "recall": 0.0, "map50": 0.0,
                            "map": 0.0, "fitness": 0.0}
            return self.results
        tp = np.concatenate(self._tp)
        conf = np.concatenate(self._conf)
        pcls = np.concatenate(self._pcls)
        tcls = np.concatenate(self._tcls)
        r = ap_per_class(tp, conf, pcls, tcls)
        ap50 = r["ap"][:, 0].mean() if len(r["ap"]) else 0.0
        ap = r["ap"].mean() if len(r["ap"]) else 0.0
        self.results = {
            "precision": float(r["precision"].mean()) if len(r["precision"]) else 0.0,
            "recall": float(r["recall"].mean()) if len(r["recall"]) else 0.0,
            "map50": float(ap50), "map": float(ap),
            "fitness": float(0.1 * ap50 + 0.9 * ap),
        }
        self.per_class = r
        return self.results

    @property
    def fitness(self):
        return self.results.get("fitness", 0.0)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                "metrics/mAP50-95(B)"]

    def mean_results(self):
        r = self.results
        return [r.get("precision", 0), r.get("recall", 0), r.get("map50", 0),
                r.get("map", 0)]


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:177-317)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(self, detections: np.ndarray, gt_boxes: np.ndarray,
                      gt_cls: np.ndarray):
        """detections: (n, 6) [x1,y1,x2,y2,conf,cls]; gts in xyxy."""
        if gt_cls.size == 0:
            if detections is not None and len(detections):
                d = detections[detections[:, 4] > self.conf]
                for dc in d[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # false negative
            return
        d = detections[detections[:, 4] > self.conf]
        iou = box_iou_numpy(gt_boxes, d[:, :4])
        gi, pi = np.nonzero(iou > self.iou_thres)
        matched = set()
        if gi.size:
            order = iou[gi, pi].argsort()[::-1]
            m = np.stack([gi, pi], 1)[order]
            m = m[np.unique(m[:, 1], return_index=True)[1]]
            m = m[np.unique(m[:, 0], return_index=True)[1]]
            for g, p_ in m:
                self.matrix[int(d[p_, 5]), int(gt_cls[g])] += 1
                matched.add((int(g), int(p_)))
        mg = {g for g, _ in matched}
        mp = {p_ for _, p_ in matched}
        for g in range(len(gt_cls)):
            if g not in mg:
                self.matrix[self.nc, int(gt_cls[g])] += 1
        for p_ in range(len(d)):
            if p_ not in mp:
                self.matrix[int(d[p_, 5]), self.nc] += 1


# ---------------------------------------------------------------------------
# Fork counting metrics — the paper's headline numbers
# ---------------------------------------------------------------------------

def counting_errors(pred_counts: Sequence[Dict[int, int]],
                    gt_counts: Sequence[Dict[int, int]],
                    classes: Sequence[int]) -> Dict[int, Dict[str, float]]:
    """Per-class count MAE / MSE / MAPE over images
    (reference nn/cal_model_count_error.py:52-66; zero-GT images are skipped
    in MAPE exactly as the reference does at :59-64)."""
    out = {}
    for c in classes:
        pred = np.array([pc.get(c, 0) for pc in pred_counts], float)
        gt = np.array([gc.get(c, 0) for gc in gt_counts], float)
        err = pred - gt
        nz = gt > 0
        mape = float(np.mean(np.abs(err[nz]) / gt[nz]) * 100) if nz.any() else 0.0
        out[c] = {"mae": float(np.mean(np.abs(err))),
                  "mse": float(np.mean(err ** 2)),
                  "mape": mape}
    return out


def counting_agreement(per_image_preds: List[np.ndarray],
                       per_image_gts: List[Tuple[np.ndarray, np.ndarray]],
                       classes: Sequence[int], iou_thr: float = 0.5):
    """Per-class TP/FP/FN at IoU>0.5 via greedy matching + count R^2
    (reference nn/cal_counting_metrics.py:90-130)."""
    stats = {c: {"tp": 0, "fp": 0, "fn": 0} for c in classes}
    pred_counts = {c: [] for c in classes}
    gt_counts = {c: [] for c in classes}
    for det, (gt_boxes, gt_cls) in zip(per_image_preds, per_image_gts):
        for c in classes:
            d = det[det[:, 5] == c] if len(det) else np.zeros((0, 6))
            g = gt_boxes[gt_cls == c] if len(gt_cls) else np.zeros((0, 4))
            pred_counts[c].append(len(d))
            gt_counts[c].append(len(g))
            if len(d) == 0:
                stats[c]["fn"] += len(g)
                continue
            if len(g) == 0:
                stats[c]["fp"] += len(d)
                continue
            iou = box_iou_numpy(d[:, :4], g)
            used = np.zeros(len(g), bool)
            tp = 0
            for i in np.argsort(-d[:, 4]):  # greedy by confidence
                j = int(np.argmax(iou[i] * ~used))
                if iou[i, j] > iou_thr and not used[j]:
                    used[j] = True
                    tp += 1
            stats[c]["tp"] += tp
            stats[c]["fp"] += len(d) - tp
            stats[c]["fn"] += len(g) - tp
    r2 = {}
    for c in classes:
        y = np.array(gt_counts[c], float)
        yhat = np.array(pred_counts[c], float)
        ss_res = np.sum((y - yhat) ** 2)
        ss_tot = np.sum((y - y.mean()) ** 2)
        r2[c] = float(1 - ss_res / ss_tot) if ss_tot > 0 else 0.0
    return stats, r2


def fitness(metrics: Dict[str, float]) -> float:
    """0.1*mAP50 + 0.9*mAP50-95 (reference metrics.py:622-626)."""
    return 0.1 * metrics.get("map50", 0.0) + 0.9 * metrics.get("map", 0.0)
