"""Input data of the PyTorch port: synthetic scenes, datasets, batches and
the letterbox; the JAX package's `data/__init__.py` names re-exported (the
letterbox is `data.augment`'s), each imported at first use."""
from .. import _lazy

__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, {
    **dict.fromkeys(("letterbox", "augment_hsv", "mosaic4", "random_perspective",
                     "train_transform"), ".augment"),
    **dict.fromkeys(("DataLoader", "build_dataloader", "collate"), ".build"),
    **dict.fromkeys(("YOLODataset", "SyntheticDetectionDataset", "DetItem"), ".dataset"),
})
