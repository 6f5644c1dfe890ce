"""The rest of the JAX package's model zoo, as literals: YOLOv3 (plain, SPP,
tiny), YOLOv5 (P5, P6), YOLOv6, YOLOv8 on P2-P5 and P3-P6 (detect and pose),
and YOLOv8's classifier. Each equals `mgdt_yolo_tpu/models/<v>/<name>.yaml`
read by a YAML parser; rows are `[from, repeats, module, args]`. The v3
files carry `depth_multiple`/`width_multiple` where the others carry
`scales`, and v6 a config-wide `activation`."""
from .ablation import SCALES

# YOLOv5's scales: no channel cap below 1024 at m and l, and x deeper
SCALES_V5 = {"n": [0.33, 0.25, 1024], "s": [0.33, 0.5, 1024], "m": [0.67, 0.75, 1024],
             "l": [1.0, 1.0, 1024], "x": [1.33, 1.25, 1024]}
SCALES_CLS = {**SCALES_V5, "x": [1.0, 1.25, 1024]}
_UP = [-1, 1, "nn.Upsample", [None, 2, "nearest"]]

# Darknet-53: layers 0-10, P3 (6), P4 (8) and P5 (10)
_V3_BACKBONE = [
    [-1, 1, "Conv", [32, 3, 1]],
    [-1, 1, "Conv", [64, 3, 2]],
    [-1, 1, "Bottleneck", [64]],
    [-1, 1, "Conv", [128, 3, 2]],
    [-1, 2, "Bottleneck", [128]],
    [-1, 1, "Conv", [256, 3, 2]],
    [-1, 8, "Bottleneck", [256]],
    [-1, 1, "Conv", [512, 3, 2]],
    [-1, 8, "Bottleneck", [512]],
    [-1, 1, "Conv", [1024, 3, 2]],
    [-1, 4, "Bottleneck", [1024]],
]


def _v3_head(p5: list) -> list:
    """YOLOv3's head after its P5 rows `p5` (five layers, 11-15)."""
    return [
        [-1, 1, "Bottleneck", [1024, False]],
        *p5,
        [-2, 1, "Conv", [256, 1, 1]],
        _UP,
        [[-1, 8], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Conv", [512, 3, 1]],
        [-2, 1, "Conv", [128, 1, 1]],
        _UP,
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [256, False]],
        [-1, 2, "Bottleneck", [256, False]],
        [[27, 22, 15], 1, "Detect", ["nc"]],
    ]


def _v5_backbone(p6: bool) -> list:
    """YOLOv5's CSP-Darknet with SPPF, to P5 (layers 0-9) or P6 (0-11)."""
    rows = [
        [-1, 1, "Conv", [64, 6, 2, 2]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 6, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 9, "C3", [512]],
    ]
    if p6:
        rows += [[-1, 1, "Conv", [768, 3, 2]], [-1, 3, "C3", [768]]]
    return rows + [[-1, 1, "Conv", [1024, 3, 2]], [-1, 3, "C3", [1024]],
                   [-1, 1, "SPPF", [1024, 5]]]


# YOLOv8's backbone to P6 (layers 0-11) and its P3-P6 neck of C2 blocks
_V8_P6 = [
    [-1, 1, "Conv", [64, 3, 2]],
    [-1, 1, "Conv", [128, 3, 2]],
    [-1, 3, "C2f", [128, True]],
    [-1, 1, "Conv", [256, 3, 2]],
    [-1, 6, "C2f", [256, True]],
    [-1, 1, "Conv", [512, 3, 2]],
    [-1, 6, "C2f", [512, True]],
    [-1, 1, "Conv", [768, 3, 2]],
    [-1, 3, "C2f", [768, True]],
    [-1, 1, "Conv", [1024, 3, 2]],
    [-1, 3, "C2f", [1024, True]],
    [-1, 1, "SPPF", [1024, 5]],
]
_V8_P6_NECK = [
    _UP,
    [[-1, 8], 1, "Concat", [1]],
    [-1, 3, "C2", [768, False]],
    _UP,
    [[-1, 6], 1, "Concat", [1]],
    [-1, 3, "C2", [512, False]],
    _UP,
    [[-1, 4], 1, "Concat", [1]],
    [-1, 3, "C2", [256, False]],
    [-1, 1, "Conv", [256, 3, 2]],
    [[-1, 17], 1, "Concat", [1]],
    [-1, 3, "C2", [512, False]],
    [-1, 1, "Conv", [512, 3, 2]],
    [[-1, 14], 1, "Concat", [1]],
    [-1, 3, "C2", [768, False]],
    [-1, 1, "Conv", [768, 3, 2]],
    [[-1, 11], 1, "Concat", [1]],
    [-1, 3, "C2", [1024, False]],
]

CONFIGS = {
    "yolov3.yaml": {
        "nc": 80, "depth_multiple": 1.0, "width_multiple": 1.0, "backbone": _V3_BACKBONE,
        "head": _v3_head([
            [-1, 1, "Conv", [512, 1, 1]],
            [-1, 1, "Conv", [1024, 3, 1]],
            [-1, 1, "Conv", [512, 1, 1]],
            [-1, 1, "Conv", [1024, 3, 1]],
        ])},
    "yolov3-spp.yaml": {
        "nc": 80, "depth_multiple": 1.0, "width_multiple": 1.0, "backbone": _V3_BACKBONE,
        "head": _v3_head([
            [-1, 1, "SPP", [512, [5, 9, 13]]],
            [-1, 1, "Conv", [1024, 3, 1]],
            [-1, 1, "Conv", [512, 1, 1]],
            [-1, 1, "Conv", [1024, 3, 1]],
        ])},
    "yolov3-tiny.yaml": {
        "nc": 80, "depth_multiple": 1.0, "width_multiple": 1.0,
        "backbone": [
            [-1, 1, "Conv", [16, 3, 1]],
            [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
            [-1, 1, "Conv", [32, 3, 1]],
            [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
            [-1, 1, "Conv", [64, 3, 1]],
            [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
            [-1, 1, "Conv", [128, 3, 1]],
            [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
            [-1, 1, "Conv", [256, 3, 1]],
            [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
            [-1, 1, "Conv", [512, 3, 1]],
            [-1, 1, "nn.ZeroPad2d", [[0, 1, 0, 1]]],
            [-1, 1, "nn.MaxPool2d", [2, 1, 0]],
        ],
        "head": [
            [-1, 1, "Conv", [1024, 3, 1]],
            [-1, 1, "Conv", [256, 1, 1]],
            [-1, 1, "Conv", [512, 3, 1]],
            [-2, 1, "Conv", [128, 1, 1]],
            _UP,
            [[-1, 8], 1, "Concat", [1]],
            [-1, 1, "Conv", [256, 3, 1]],
            [[19, 15], 1, "Detect", ["nc"]],
        ]},
    "yolov5.yaml": {
        "nc": 80, "scales": SCALES_V5, "backbone": _v5_backbone(False),
        "head": [
            [-1, 1, "Conv", [512, 1, 1]],
            _UP,
            [[-1, 6], 1, "Concat", [1]],
            [-1, 3, "C3", [512, False]],
            [-1, 1, "Conv", [256, 1, 1]],
            _UP,
            [[-1, 4], 1, "Concat", [1]],
            [-1, 3, "C3", [256, False]],
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 14], 1, "Concat", [1]],
            [-1, 3, "C3", [512, False]],
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 10], 1, "Concat", [1]],
            [-1, 3, "C3", [1024, False]],
            [[17, 20, 23], 1, "Detect", ["nc"]],
        ]},
    "yolov5-p6.yaml": {
        "nc": 80, "scales": SCALES_V5, "backbone": _v5_backbone(True),
        "head": [
            [-1, 1, "Conv", [768, 1, 1]],
            _UP,
            [[-1, 8], 1, "Concat", [1]],
            [-1, 3, "C3", [768, False]],
            [-1, 1, "Conv", [512, 1, 1]],
            _UP,
            [[-1, 6], 1, "Concat", [1]],
            [-1, 3, "C3", [512, False]],
            [-1, 1, "Conv", [256, 1, 1]],
            _UP,
            [[-1, 4], 1, "Concat", [1]],
            [-1, 3, "C3", [256, False]],
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 20], 1, "Concat", [1]],
            [-1, 3, "C3", [512, False]],
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 16], 1, "Concat", [1]],
            [-1, 3, "C3", [768, False]],
            [-1, 1, "Conv", [768, 3, 2]],
            [[-1, 12], 1, "Concat", [1]],
            [-1, 3, "C3", [1024, False]],
            [[23, 26, 29, 32], 1, "Detect", ["nc"]],
        ]},
    "yolov6.yaml": {
        "nc": 80, "activation": "nn.ReLU()", "scales": SCALES,
        "backbone": [
            [-1, 1, "Conv", [64, 3, 2]],
            [-1, 1, "Conv", [128, 3, 2]],
            [-1, 6, "Conv", [128, 3, 1]],
            [-1, 1, "Conv", [256, 3, 2]],
            [-1, 12, "Conv", [256, 3, 1]],
            [-1, 1, "Conv", [512, 3, 2]],
            [-1, 18, "Conv", [512, 3, 1]],
            [-1, 1, "Conv", [1024, 3, 2]],
            [-1, 6, "Conv", [1024, 3, 1]],
            [-1, 1, "SPPF", [1024, 5]],
        ],
        "head": [
            [-1, 1, "Conv", [256, 1, 1]],
            [-1, 1, "nn.ConvTranspose2d", [256, 2, 2, 0]],
            [[-1, 6], 1, "Concat", [1]],
            [-1, 1, "Conv", [256, 3, 1]],
            [-1, 9, "Conv", [256, 3, 1]],
            [-1, 1, "Conv", [128, 1, 1]],
            [-1, 1, "nn.ConvTranspose2d", [128, 2, 2, 0]],
            [[-1, 4], 1, "Concat", [1]],
            [-1, 1, "Conv", [128, 3, 1]],
            [-1, 9, "Conv", [128, 3, 1]],
            [-1, 1, "Conv", [128, 3, 2]],
            [[-1, 15], 1, "Concat", [1]],
            [-1, 1, "Conv", [256, 3, 1]],
            [-1, 9, "Conv", [256, 3, 1]],
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 10], 1, "Concat", [1]],
            [-1, 1, "Conv", [512, 3, 1]],
            [-1, 9, "Conv", [512, 3, 1]],
            [[19, 23, 27], 1, "Detect", ["nc"]],
        ]},
    "yolov8-p2.yaml": {
        "nc": 80, "scales": SCALES, "backbone": _V8_P6[:7] + [
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
            _UP,
            [[-1, 2], 1, "Concat", [1]],
            [-1, 3, "C2f", [128]],
            [-1, 1, "Conv", [128, 3, 2]],
            [[-1, 15], 1, "Concat", [1]],
            [-1, 3, "C2f", [256]],
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 12], 1, "Concat", [1]],
            [-1, 3, "C2f", [512]],
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 9], 1, "Concat", [1]],
            [-1, 3, "C2f", [1024]],
            [[18, 21, 24, 27], 1, "Detect", ["nc"]],
        ]},
    "yolov8-p6.yaml": {
        "nc": 80, "scales": SCALES, "backbone": _V8_P6,
        "head": [*_V8_P6_NECK, [[20, 23, 26, 29], 1, "Detect", ["nc"]]]},
    "yolov8-pose-p6.yaml": {
        "nc": 1, "kpt_shape": [17, 3], "scales": SCALES, "backbone": _V8_P6,
        "head": [*_V8_P6_NECK, [[20, 23, 26, 29], 1, "Pose", ["nc", [17, 3]]]]},
    "yolov8-cls.yaml": {
        "nc": 1000, "scales": SCALES_CLS,
        "backbone": _V8_P6[:7] + [
            [-1, 1, "Conv", [1024, 3, 2]],
            [-1, 3, "C2f", [1024, True]],
        ],
        "head": [[-1, 1, "Classify", ["nc"]]]},
}
