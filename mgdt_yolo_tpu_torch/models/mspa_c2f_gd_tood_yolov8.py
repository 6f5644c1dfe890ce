"""The flagship MGDT architecture (MSPA-C2f backbone, GD neck, TOOD head).

A Python literal of `mgdt_yolo_tpu/models/v8/mspa_c2f_gd_tood_yolov8.yaml`,
so the port needs no YAML parser. Rows are `[from, repeats, module, args]`;
`scales` maps a scale letter to `[depth, width, max_channels]`.
"""

CONFIG = {
    "nc": 2,
    "scales": {
        "n": [0.33, 0.25, 1024],
        "s": [0.33, 0.5, 1024],
        "m": [0.67, 0.75, 768],
        "l": [1.0, 1.0, 512],
        "x": [1.0, 1.25, 512],
    },
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, "MSPA_C2f", [128, True]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 6, "MSPA_C2f", [256, True]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 6, "MSPA_C2f", [512, True]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 3, "MSPA_C2f", [1024, True]],
        [-1, 1, "SPPF", [1024, 5]],
    ],
    "head": [
        [[2, 4, 6, 9], 1, "SimFusion_4in", []],
        [-1, 1, "IFM", [[64, 32]]],
        [6, 1, "Conv", [256, 1, 1]],
        [[2, 4, -1], 1, "SimFusion_3in", [256]],
        [[-1, 11], 1, "InjectionMultiSum_Auto_pool", [256, [64, 32], 1]],
        [-1, 3, "C2f", [256]],
        [[15], 1, "TOODHead", ["nc", 64]],
    ],
}
