"""The keys of the JAX package's `cfg/default.yaml` that the port's trainer
and validator honour, as a Python literal (the GPU host has no PyYAML),
with the same values but one: `device_augment` is True here. The JAX
default (False) selects the host augmentation pipeline, which needs cv2 and
is not ported; the device pipeline is the port's only augmentation, so
`device_augment=False` requires every augmentation key at 0 (`UNAUGMENTED`).
"""
TRAIN_DEFAULTS = {
    "epochs": 100,            # training epochs
    "patience": 50,           # early-stop patience (epochs without fitness gain)
    "batch": 16,              # global batch size
    "imgsz": 640,             # square train/val image size
    "save": True,             # write checkpoints
    "save_period": -1,        # extra checkpoint every N epochs (<1 disables)
    "optimizer": "auto",      # SGD | AdamW | auto
    "seed": 0,                # data shuffle and augmentation seed
    "cos_lr": False,          # cosine LR schedule instead of linear
    "close_mosaic": 0,        # disable mosaic for the last N epochs
    "amp": True,              # bf16 autocast on the GPU (parameters stay float32)
    # validation
    "val": True,              # validate with the EMA weights after every epoch
    "conf": None,             # confidence threshold (0.001 for validation when unset)
    "iou": 0.7,               # NMS IoU threshold
    "max_det": 300,           # max detections per image
    # hyperparameters
    "lr0": 0.001,             # initial LR (the fork's value)
    "lrf": 0.01,              # final LR fraction
    "momentum": 0.937,        # SGD momentum / Adam beta1
    "weight_decay": 0.0005,   # on conv/linear kernels only
    "warmup_epochs": 3.0,     # LR warmup length in epochs
    "warmup_momentum": 0.8,   # momentum at warmup start
    "warmup_bias_lr": 0.1,    # bias LR at warmup start
    "box": 7.5,               # box loss gain
    "cls": 0.5,               # cls loss gain
    "dfl": 1.5,               # dfl loss gain
    "nbs": 64,                # nominal batch size for loss/wd scaling
    # augmentation
    "hsv_h": 0.015,           # HSV hue jitter fraction
    "hsv_s": 0.7,             # HSV saturation jitter fraction
    "hsv_v": 0.4,             # HSV value jitter fraction
    "degrees": 0.0,           # rotation: not supported on the device
    "translate": 0.1,         # translation (+/- fraction)
    "scale": 0.5,             # scale (+/- gain)
    "shear": 0.0,             # shear: not supported on the device
    "perspective": 0.0,       # perspective: not supported on the device
    "flipud": 0.0,            # vertical flip probability
    "fliplr": 0.0,            # horizontal flip probability (the fork's value)
    "mosaic": 1.0,            # mosaic probability
    "mosaic9": 0.0,           # 3x3 mosaic: not supported on the device
    "device_augment": True,   # mosaic/warp/flip/HSV on the device (the JAX default is False)
    "mixup": 0.0,             # mixup: not supported on the device
    "copy_paste": 0.0,        # copy-paste: not supported on the device
}

# every augmentation key; with device_augment=False each must be 0
AUGMENT_KEYS = ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
                "perspective", "flipud", "fliplr", "mosaic", "mosaic9", "mixup", "copy_paste")

# overrides for training on unaugmented scenes (square items at the train size)
UNAUGMENTED = {"device_augment": False, **dict.fromkeys(AUGMENT_KEYS, 0.0)}
