"""Multi-object tracking over the predictor's detections: ByteTrack and
BoT-SORT (with the camera's motion compensated without cv2), the
counterpart of the JAX package's `mgdt_yolo_tpu/tracker`. Host code in
numpy and scipy, run once per frame; `YOLO.track` registers it on the
predictor's callbacks (`track.register_tracker`)."""
from .bot_sort import BOTSORT, BOTrack
from .byte_tracker import BYTETracker, STrack
from .track import register_tracker

__all__ = ["BYTETracker", "BOTSORT", "STrack", "BOTrack", "register_tracker"]
