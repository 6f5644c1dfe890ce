"""PyTorch/CUDA port of the MGDT-YOLO serving and training paths.

A second package beside `mgdt_yolo_tpu` (the JAX reference, which this
package never imports). Public functions keep the reference's NHWC layout;
inside, modules are ordinary NCHW `nn.Module`s. Entry points run on the GPU
unless the caller passes `device="cpu"` (see `device.resolve_device`).
The hand-written kernels of these paths are the DCNv2 forward
(`csrc/deform_fwd.cu`) and backward (`csrc/deform_bwd.cu`), registered as
the operators `mgdt::deform_fwd` and `mgdt::deform_bwd` by
`ops/cuda_deform.py`, and the augmentation's flip + HSV pass
(`csrc/fused_augment.cu`). `YOLO` (`engine/model.py`) is the facade
and `DetectionModel` (`nn/tasks.py`) the model, both imported when first
used; `python -m mgdt_yolo_tpu_torch` the command line.
"""
__version__ = "0.1.0"

from . import _lazy
from .device import resolve_device

# lazy: the facade pulls in the whole stack
__getattr__, __dir__, __all__ = _lazy.lazy_exports(
    __name__, {"DetectionModel": ".nn.tasks", "YOLO": ".engine.model"},
    own=("resolve_device", "__version__"))
