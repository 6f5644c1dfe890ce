"""Entry points of the PyTorch port: the facade, the predictor, results,
the server, the trainer and the validator; the JAX package's
`engine/__init__.py` names re-exported (`TrainState` is not ported:
ROADMAP, "Not to port"), each imported at first use, so that importing a
sibling module does not build the whole engine."""
from .. import _lazy

__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, {
    "YOLO": ".model", "TASK_MAP": ".model",
    "BaseTrainer": ".trainer", "DetectionTrainer": ".trainer", "EarlyStopping": ".trainer",
    "BaseValidator": ".validator", "DetectionValidator": ".validator",
    "BasePredictor": ".predictor", "DetectionPredictor": ".predictor",
    "InferenceServer": ".serve", "Results": ".results", "Boxes": ".results"})
