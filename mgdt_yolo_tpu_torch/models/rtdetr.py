"""RT-DETR's configs, as literals: `rtdetr-l` and `rtdetr-x` (the HGNetV2
backbone, AIFI, the RepC3 neck) and `yolov8-rtdetr` (YOLOv8's backbone and
PAN at its n-x scales), each ending in `RTDETRDecoder` over three levels.
Each equals `mgdt_yolo_tpu/models/{rt-detr,v8}/<name>.yaml` read by a YAML
parser; rows are `[from, repeats, module, args]`."""
from .ablation import SCALES

_UP = [-1, 1, "nn.Upsample", [None, 2, "nearest"]]


def _rtdetr_head(c: int, cm: int, p4: int, p3: int, first: int) -> list:
    """RT-DETR's hybrid encoder (AIFI of feed-forward width `cm` on the last
    backbone layer, linear 1x1 projections of layers `p4` and `p3`) and
    decoder at width `c`; `first` is the head's first layer index."""
    return [
        [-1, 1, "Conv", [c, 1, 1, None, 1, 1, False]],
        [-1, 1, "AIFI", [cm, 8]],
        [-1, 1, "Conv", [c, 1, 1]],
        _UP,
        [p4, 1, "Conv", [c, 1, 1, None, 1, 1, False]],
        [[-2, -1], 1, "Concat", [1]],
        [-1, 3, "RepC3", [c]],
        [-1, 1, "Conv", [c, 1, 1]],
        _UP,
        [p3, 1, "Conv", [c, 1, 1, None, 1, 1, False]],
        [[-2, -1], 1, "Concat", [1]],
        [-1, 3, "RepC3", [c]],
        [-1, 1, "Conv", [c, 3, 2]],
        [[-1, first + 7], 1, "Concat", [1]],
        [-1, 3, "RepC3", [c]],
        [-1, 1, "Conv", [c, 3, 2]],
        [[-1, first + 2], 1, "Concat", [1]],
        [-1, 3, "RepC3", [c]],
        [[first + 11, first + 14, first + 17], 1, "RTDETRDecoder", ["nc"]],
    ]


RTDETR_L = {
    "nc": 80,
    "scales": {"l": [1.0, 1.0, 1024]},
    "backbone": [
        [-1, 1, "HGStem", [32, 48]],
        [-1, 6, "HGBlock", [48, 128, 3]],
        [-1, 1, "DWConv", [128, 3, 2, 1, False]],
        [-1, 6, "HGBlock", [96, 512, 3]],
        [-1, 1, "DWConv", [512, 3, 2, 1, False]],
        [-1, 6, "HGBlock", [192, 1024, 5, True, False]],
        [-1, 6, "HGBlock", [192, 1024, 5, True, True]],
        [-1, 6, "HGBlock", [192, 1024, 5, True, True]],
        [-1, 1, "DWConv", [1024, 3, 2, 1, False]],
        [-1, 6, "HGBlock", [384, 2048, 5, True, False]],
    ],
    "head": _rtdetr_head(256, 1024, 7, 3, 10),
}

RTDETR_X = {
    "nc": 80,
    "scales": {"x": [1.0, 1.0, 2048]},
    "backbone": [
        [-1, 1, "HGStem", [32, 64]],
        [-1, 6, "HGBlock", [64, 128, 3]],
        [-1, 1, "DWConv", [128, 3, 2, 1, False]],
        [-1, 6, "HGBlock", [128, 512, 3]],
        [-1, 6, "HGBlock", [128, 512, 3, False, True]],
        [-1, 1, "DWConv", [512, 3, 2, 1, False]],
        [-1, 6, "HGBlock", [256, 1024, 5, True, False]],
        [-1, 6, "HGBlock", [256, 1024, 5, True, True]],
        [-1, 6, "HGBlock", [256, 1024, 5, True, True]],
        [-1, 6, "HGBlock", [256, 1024, 5, True, True]],
        [-1, 6, "HGBlock", [256, 1024, 5, True, True]],
        [-1, 1, "DWConv", [1024, 3, 2, 1, False]],
        [-1, 6, "HGBlock", [512, 2048, 5, True, False]],
        [-1, 6, "HGBlock", [512, 2048, 5, True, True]],
    ],
    "head": _rtdetr_head(384, 2048, 10, 4, 14),
}

YOLOV8_RTDETR = {
    "nc": 80,
    "scales": SCALES,
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, "C2f", [128, True]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 6, "C2f", [256, True]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 6, "C2f", [512, True]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 3, "C2f", [1024, True]],
        [-1, 1, "SPPF", [1024, 5]],
    ],
    "head": [
        _UP,
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C2f", [512]],
        _UP,
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C2f", [256]],
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 12], 1, "Concat", [1]],
        [-1, 3, "C2f", [512]],
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 3, "C2f", [1024]],
        [[15, 18, 21], 1, "RTDETRDecoder", ["nc"]],
    ],
}

CONFIGS = {"rtdetr-l.yaml": RTDETR_L, "rtdetr-x.yaml": RTDETR_X,
           "yolov8-rtdetr.yaml": YOLOV8_RTDETR}
