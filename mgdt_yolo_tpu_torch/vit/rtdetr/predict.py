"""RT-DETR's predictor: no NMS, a confidence filter over the last decoder
layer's queries; the counterpart of `mgdt_yolo_tpu/vit/rtdetr/predict.py`.

Each image is stretched to the `imgsz` square (`letterbox(scale_fill=
True)`, as the reference's pre-transform does: the only geometry under
which the normalised boxes map back by multiplying with the image's width
and height), the model runs in eval mode (Conv+BN folded, bf16 with
`half`), and every query whose best class score is above `conf` (0.25 when
unset) becomes a detection: its xywh box in xyxy times (w0, h0, w0, h0),
that score and that class.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...data.augment import letterbox
from ...engine.predictor import CONF, BasePredictor
from ...ops.boxes import xywh2xyxy


class RTDETRPredictor(BasePredictor):
    """`RTDETRPredictor(overrides={...}).setup_model(model)(source,
    batch=...)`: `Results` per image; see the module's text."""

    def preprocess(self, imgs: List[np.ndarray]):
        s = self.args.imgsz
        out = [letterbox(im, (s, s), scale_fill=True)[0][..., ::-1] for im in imgs]
        return np.stack(out), [im.shape[:2] for im in imgs]

    @torch.no_grad()
    def detect(self, x: torch.Tensor, chunk: List[Dict], meta) -> List[np.ndarray]:
        bboxes, scores = queries(self.model, x)
        bb = xywh2xyxy(bboxes.float()).cpu().numpy()
        sc = scores.float().cpu().numpy()
        return [keep_queries(bb[j], sc[j], self.args.conf or CONF, scale=[w0, h0, w0, h0])
                for j, (h0, w0) in enumerate(meta)]


@torch.no_grad()
def queries(model, x: torch.Tensor):
    """The last decoder layer's normalised xywh boxes (b, nq, 4) and sigmoid
    scores (b, nq, nc) of a uint8 (or [0, 1] float) NHWC batch."""
    if not x.is_floating_point():
        x = x.float() / 255.0
    dec_bboxes, dec_scores = model(x)[:2]
    return dec_bboxes[-1], dec_scores[-1]


def keep_queries(bb_xyxy: np.ndarray, scores: np.ndarray, conf: float, scale) -> np.ndarray:
    """Rows [x1, y1, x2, y2, score, class] of the queries whose best class
    score is above `conf`, in query order, boxes times `scale` with numpy's
    promotion (a list of ints gives float64 rows, as JAX's predictor
    computes them; a float32 scale float32 rows, as its validator)."""
    cls = scores.argmax(-1)
    val = scores.max(-1)
    keep = val > conf
    return np.concatenate([bb_xyxy[keep] * scale, val[keep, None],
                           cls[keep, None].astype(np.float32)], axis=1)
