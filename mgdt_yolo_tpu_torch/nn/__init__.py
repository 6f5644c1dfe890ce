"""Modules and the model graph of the PyTorch port; the model classes and
graph helpers of `nn/tasks.py` re-exported by name, as the JAX package's
`nn/__init__.py` does (`GraphModel` is not ported: ROADMAP, "Not to
port"), each imported at first use."""
from .. import _lazy

__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, dict.fromkeys((
    "BaseModel", "DetectionModel", "SegmentationModel", "PoseModel", "ClassificationModel",
    "LayerSpec", "parse_model", "yaml_model_load", "guess_model_task"), ".tasks"))
