"""The run configuration of the JAX package's `cfg/default.yaml`, as Python
literals (the GPU host has no PyYAML).

`CFG_DEFAULTS` is its full key set with its defaults: a key outside it is
not a configuration key at all. `TRAIN_DEFAULTS` holds the keys that the
port's trainer and validator honour, with the same values. As in JAX,
`device_augment=False` (the default) augments on the host
(`data.augment.train_transform`, cv2's arithmetic in numpy) and
`device_augment=True` on the device, unless a key the device pipeline cannot
honour (`degrees`, `shear`, `perspective`, `mixup`, `copy_paste`,
`mosaic9`) is set, which falls back to the host with JAX's warning.
`UNAUGMENTED` sets every augmentation key to 0 on the host path. `plots`
is honoured: it draws, and takes one batch from the loader before training
as JAX does. `NEUTRAL_KEYS` are the keys the port accepts at any value
because they change neither the weights nor the metrics; every other key of `CFG_DEFAULTS` must keep its
default, or the `Trainer` raises (`engine/trainer.check_train_args`).
"""
CFG_DEFAULTS = {
    "task": "detect", "mode": "train", "model": None, "data": None,
    # train
    "epochs": 100, "patience": 50, "batch": 16, "imgsz": 640, "save": True,
    "save_period": -1, "cache": False, "device": None, "tp": 1, "fsdp": False,
    "workers": 8, "project": None, "name": None, "exist_ok": False, "pretrained": True,
    "optimizer": "auto", "verbose": True, "seed": 0, "deterministic": True,
    "single_cls": False, "rect": False, "cos_lr": False, "close_mosaic": 0,
    "resume": False, "amp": True, "fraction": 1.0, "profile": False,
    "overlap_mask": True, "mask_ratio": 4, "dropout": 0.0,
    # val
    "val": True, "split": "val", "save_json": False, "save_hybrid": False, "conf": None,
    "iou": 0.7, "max_det": 300, "half": False, "dnn": False, "plots": True,
    # predict
    "source": None, "show": False, "save_txt": False, "save_conf": False,
    "save_crop": False, "show_labels": True, "show_conf": True, "vid_stride": 1,
    "line_width": None, "visualize": False, "augment": False, "agnostic_nms": False,
    "classes": None, "retina_masks": False, "boxes": True, "tracker": "botsort.yaml",
    # export
    "format": "stablehlo", "keras": False, "optimize": False, "int8": False,
    "dynamic": False, "simplify": False, "opset": None, "workspace": 4, "nms": False,
    # hyperparameters
    "lr0": 0.001, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "box": 7.5,
    "cls": 0.5, "dfl": 1.5, "pose": 12.0, "kobj": 1.0, "label_smoothing": 0.0, "nbs": 64,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0, "translate": 0.1,
    "scale": 0.5, "shear": 0.0, "perspective": 0.0, "flipud": 0.0, "fliplr": 0.0,
    "mosaic": 1.0, "mosaic9": 0.0, "device_augment": False, "mixup": 0.0,
    "copy_paste": 0.0,
    # override file; debug
    "cfg": None, "v5loader": False,
}

TRAIN_DEFAULTS = {
    "data": None,             # dataset YAML or directory; None: the synthetic scenes
    "epochs": 100,            # training epochs
    "patience": 50,           # early-stop patience (epochs without fitness gain)
    "batch": 16,              # global batch size
    "imgsz": 640,             # square train/val image size
    "save": True,             # write checkpoints
    "save_period": -1,        # extra checkpoint every N epochs (<1 disables)
    "cache": False,           # decoded train/val images kept: ram (True) or disk (.npy)
    "fraction": 1.0,          # share of the train images used (the first ones, sorted)
    "single_cls": False,      # every class taken as class 0
    "resume": False,          # carry on the newest run's weights/last under `project`
    "optimizer": "auto",      # SGD | AdamW | RMSProp | auto
    "seed": 0,                # data shuffle and augmentation seed
    "cos_lr": False,          # cosine LR schedule instead of linear
    "close_mosaic": 0,        # disable mosaic for the last N epochs
    "amp": True,              # bf16 autocast on the GPU (parameters stay float32)
    # validation
    "val": True,              # validate with the EMA weights after every epoch
    "conf": None,             # confidence threshold (0.001 for validation when unset)
    "iou": 0.7,               # NMS IoU threshold
    "max_det": 300,           # max detections per image
    "agnostic_nms": False,    # NMS across classes (boxes of any class suppress each other)
    "rect": False,            # rectangular validation batches (by aspect, stride-aligned)
    "save_json": False,       # COCO json of the validation detections (predictions.json)
    "plots": True,            # labels.jpg, train_batch0.jpg (one batch taken from the
                              # loader before training), val batch 0, confusion matrix
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
    "pose": 12.0,             # keypoint loss gain (pose task)
    "kobj": 1.0,              # keypoint visibility loss gain (pose task)
    "nbs": 64,                # nominal batch size for loss/wd scaling
    # augmentation
    "hsv_h": 0.015,           # HSV hue jitter fraction
    "hsv_s": 0.7,             # HSV saturation jitter fraction
    "hsv_v": 0.4,             # HSV value jitter fraction
    "degrees": 0.0,           # rotation (+/- degrees; host pipeline only)
    "translate": 0.1,         # translation (+/- fraction)
    "scale": 0.5,             # scale (+/- gain)
    "shear": 0.0,             # shear (+/- degrees; host pipeline only)
    "perspective": 0.0,       # perspective (+/- fraction; host pipeline only)
    "flipud": 0.0,            # vertical flip probability
    "fliplr": 0.0,            # horizontal flip probability (the fork's value)
    "mosaic": 1.0,            # mosaic probability
    "mosaic9": 0.0,           # 3x3 mosaic probability (host pipeline only)
    "device_augment": False,  # mosaic/warp/flip/HSV on the device (K3) instead of the host
    "mixup": 0.0,             # mixup probability (host pipeline only)
    "copy_paste": 0.0,        # copy-paste probability (segment items only)
}

# every augmentation key
AUGMENT_KEYS = ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
                "perspective", "flipud", "fliplr", "mosaic", "mosaic9", "mixup", "copy_paste")

# overrides for training without augmentation: the host path with every key 0
# (an item letterboxed to the train size; Albumentations' p=0.01 filters stay,
# as in JAX)
UNAUGMENTED = {"device_augment": False, **dict.fromkeys(AUGMENT_KEYS, 0.0)}

# keys accepted at any value: they change neither the weights nor the metrics
NEUTRAL_KEYS = (
    "workers",    # host data workers; the port's loaders run in the calling process
    "verbose",    # logging only
    "project",    # names of the run directory; the port writes to `save_dir`
    "name",
    "exist_ok",   # reuse of that directory
    "device",     # only where it names the model's device (checked by the Trainer)
)

# the optimizer names the port's `Optimizer` takes (the JAX chain's)
PORTED_OPTIMIZERS = ("auto", "SGD", "sgd", "AdamW", "Adam", "adamw", "adam", "NAdam", "RAdam",
                     "RMSProp")

# typed key groups, as the JAX package's `cfg/__init__.py` checks them
CFG_FLOAT_KEYS = ("warmup_epochs", "box", "cls", "dfl", "degrees", "shear")
CFG_FRACTION_KEYS = (
    "dropout", "iou", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum",
    "warmup_bias_lr", "label_smoothing", "hsv_h", "hsv_s", "hsv_v", "translate",
    "scale", "perspective", "flipud", "fliplr", "mosaic", "mosaic9", "mixup",
    "copy_paste", "conf", "fraction")
CFG_INT_KEYS = ("epochs", "patience", "batch", "workers", "seed", "close_mosaic",
                "mask_ratio", "max_det", "vid_stride", "line_width", "workspace",
                "nbs", "save_period")
CFG_BOOL_KEYS = (
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
    "overlap_mask", "val", "save_json", "save_hybrid", "half", "dnn", "plots", "show",
    "save_txt", "save_conf", "save_crop", "show_labels", "show_conf", "visualize",
    "augment", "device_augment", "agnostic_nms", "retina_masks", "boxes", "keras",
    "optimize", "int8", "dynamic", "simplify", "nms", "profile", "v5loader")
