"""The vision-transformer models of the port: RT-DETR (`vit/rtdetr/`), the
DETR training utilities (`vit/utils/`) and SAM (`vit/sam/`: `SAM`, `Sam`),
the counterparts of `mgdt_yolo_tpu/vit/`."""
from .rtdetr.model import RTDETR

__all__ = ["RTDETR"]
