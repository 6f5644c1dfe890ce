from .model import RTDETR
from .predict import RTDETRPredictor
from .train import RTDETRTrainer
from .val import RTDETRValidator

__all__ = ["RTDETR", "RTDETRPredictor", "RTDETRTrainer", "RTDETRValidator"]
