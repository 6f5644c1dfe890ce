"""Model configurations of the PyTorch port, as Python literals, by the file
name of the JAX package's YAML each one copies (`mgdt_yolo_tpu/models/v8/`):
the eight models of the paper's ablation matrix (`ABLATION`) and YOLOv8's
segment and pose models."""
from __future__ import annotations

import copy
import re
from pathlib import Path

from .ablation import CONFIGS as _ABLATION
from .mspa_c2f_gd_tood_yolov8 import CONFIG as _FLAGSHIP
from .seg_pose import CONFIGS as _SEG_POSE

FLAGSHIP = "mspa_c2f_gd_tood_yolov8.yaml"
# the eight models of the paper's ablation matrix
ABLATION = {**_ABLATION, FLAGSHIP: _FLAGSHIP}
CONFIGS = {**ABLATION, **_SEG_POSE}


def load_config(name) -> dict:
    """A copy of the config a YAML file name names, as the JAX package's
    `yaml_model_load` reads it: a scale letter after the version
    ("yolov8n.yaml") picks that scale of "yolov8.yaml" and is kept as
    `scale`; the name given is kept as `yaml_file`. KeyError for a name
    the port has no config for."""
    name = Path(str(name)).name
    unified = re.sub(r"(\d+)([nslmx])(.+)?$", r"\1\3", name)
    if unified not in CONFIGS:
        raise KeyError(f"no config for {name!r}; the port has {sorted(CONFIGS)}")
    d = copy.deepcopy(CONFIGS[unified])
    m = re.search(r"yolov\d+([nslmx])", Path(name).stem)
    d["scale"] = m.group(1) if m else ""
    d["yaml_file"] = name
    return d
