"""The seven other models of the MGDT-YOLO ablation matrix, as literals.

Each config equals `mgdt_yolo_tpu/models/v8/<name>.yaml` read by a YAML
parser (nc 80, as the files have it); it is put together from the three
parts the files share: the backbone (C2f or MSPA_C2f), and one of two
necks, YOLOv8's 3-scale PAN or GOLD-YOLO's gather-and-distribute, with its
head row. Rows are `[from, repeats, module, args]`.
"""

SCALES = {
    "n": [0.33, 0.25, 1024],
    "s": [0.33, 0.5, 1024],
    "m": [0.67, 0.75, 768],
    "l": [1.0, 1.0, 512],
    "x": [1.0, 1.25, 512],
}


def _backbone(block: str) -> list:
    """The v8 backbone with `block` ("C2f" or "MSPA_C2f") at every stage."""
    return [
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, block, [128, True]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 6, block, [256, True]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 6, block, [512, True]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 3, block, [1024, True]],
        [-1, 1, "SPPF", [1024, 5]],
    ]


# YOLOv8's PAN neck: layers 10-21, P3 (15), P4 (18) and P5 (21)
_PAN = [
    [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
    [[-1, 6], 1, "Concat", [1]],
    [-1, 3, "C2f", [512]],
    [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
    [[-1, 4], 1, "Concat", [1]],
    [-1, 3, "C2f", [256]],
    [-1, 1, "Conv", [256, 3, 2]],
    [[-1, 12], 1, "Concat", [1]],
    [-1, 3, "C2f", [512]],
    [-1, 1, "Conv", [512, 3, 2]],
    [[-1, 9], 1, "Concat", [1]],
    [-1, 3, "C2f", [1024]],
]

# GOLD-YOLO's gather-and-distribute neck: layers 10-15, one stride-8 output
_GD = [
    [[2, 4, 6, 9], 1, "SimFusion_4in", []],
    [-1, 1, "IFM", [[64, 32]]],
    [6, 1, "Conv", [256, 1, 1]],
    [[2, 4, -1], 1, "SimFusion_3in", [256]],
    [[-1, 11], 1, "InjectionMultiSum_Auto_pool", [256, [64, 32], 1]],
    [-1, 3, "C2f", [256]],
]


def _config(block: str, neck: list, head: list) -> dict:
    return {"nc": 80, "scales": SCALES, "backbone": _backbone(block),
            "head": [*neck, head]}


CONFIGS = {
    # baseline: YOLOv8, Detect on P3-P5
    "yolov8.yaml": _config("C2f", _PAN, [[15, 18, 21], 1, "Detect", ["nc"]]),
    "mspa_c2f_yolov8.yaml": _config("MSPA_C2f", _PAN, [[15, 18, 21], 1, "Detect", ["nc"]]),
    # TOOD on P4 alone; layers 19-21 still run, and reach no head
    "thead_yolov8.yaml": _config("C2f", _PAN, [[18], 1, "TOODHead", ["nc", 128]]),
    "mspa_c2f_thead_yolov8.yaml": _config("MSPA_C2f", _PAN,
                                          [[18], 1, "TOODHead", ["nc", 128]]),
    "gd_yolov8.yaml": _config("C2f", _GD, [[15], 1, "Detect", ["nc"]]),
    "mspa_c2f_gd_yolov8.yaml": _config("MSPA_C2f", _GD, [[15], 1, "Detect", ["nc"]]),
    "gd_thead_yolov8.yaml": _config("C2f", _GD, [[15], 1, "TOODHead", ["nc", 64]]),
}
