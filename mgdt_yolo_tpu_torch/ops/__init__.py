"""Tensor operations of the PyTorch port: resampling, boxes, DCNv2, NMS;
the JAX package's `ops/__init__.py` names re-exported, each imported at
first use."""
from .. import _lazy

_NAMES = {
    **dict.fromkeys(("bbox2dist", "bbox_iou", "box_iou", "clip_boxes", "dist2bbox",
                     "make_anchors", "scale_boxes", "xywh2xyxy", "xywhn2xyxy", "xyxy2xywh"),
                    ".boxes"),
    **dict.fromkeys(("adaptive_avg_pool2d", "h_sigmoid", "interpolate_bilinear",
                     "max_pool2d_same", "upsample_nearest"), ".common"),
    "modulated_deform_conv2d": ".deform",
    **dict.fromkeys(("nms_single", "nms_single_fixpoint", "non_max_suppression"), ".nms"),
}
__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, _NAMES)
