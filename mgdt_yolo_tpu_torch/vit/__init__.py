"""The vision-transformer models of the port: RT-DETR (`vit/rtdetr/`) and
the DETR training utilities (`vit/utils/`), the counterparts of
`mgdt_yolo_tpu/vit/`. SAM is not ported yet (ROADMAP queue 1, item 11)."""
from .rtdetr.model import RTDETR

__all__ = ["RTDETR"]
