"""PyTorch/CUDA port of the MGDT-YOLO serving and training paths.

A second package beside `mgdt_yolo_tpu` (the JAX reference, which this
package never imports). Public functions keep the reference's NHWC layout;
inside, modules are ordinary NCHW `nn.Module`s. Entry points run on the GPU
unless the caller passes `device="cpu"` (see `device.resolve_device`).
The hand-written kernels of these paths are the DCNv2 forward
(`csrc/deform_fwd.cu`) and backward (`csrc/deform_bwd.cu`), paired in one
autograd Function by `ops/cuda_deform.py`.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
