"""YOLOv8's segment and pose models, as literals: each equals
`mgdt_yolo_tpu/models/v8/<name>.yaml` read by a YAML parser (the v8 backbone
and PAN neck of `ablation.py`, the `Segment` or `Pose` head on P3-P5)."""
from .ablation import _PAN, SCALES, _backbone

CONFIGS = {
    "yolov8-seg.yaml": {"nc": 80, "scales": SCALES, "backbone": _backbone("C2f"),
                        "head": [*_PAN, [[15, 18, 21], 1, "Segment", ["nc", 32, 256]]]},
    "yolov8-pose.yaml": {"nc": 1, "kpt_shape": [17, 3], "scales": SCALES,
                         "backbone": _backbone("C2f"),
                         "head": [*_PAN, [[15, 18, 21], 1, "Pose", ["nc", [17, 3]]]]},
}
