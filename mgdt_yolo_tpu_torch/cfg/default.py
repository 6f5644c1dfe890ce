"""The training keys of the JAX package's `cfg/default.yaml` that the port's
trainer honours, as a Python literal (the GPU host has no PyYAML), with the
same values. Augmentation keys are absent: this trainer feeds unaugmented
scenes, which is what those keys at 0 give in the JAX trainer.
"""
TRAIN_DEFAULTS = {
    "epochs": 100,            # training epochs
    "batch": 16,              # global batch size
    "imgsz": 640,             # square train image size
    "optimizer": "auto",      # SGD | AdamW | auto
    "seed": 0,                # data shuffle seed
    "cos_lr": False,          # cosine LR schedule instead of linear
    "amp": True,              # bf16 autocast on the GPU (parameters stay float32)
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
}
