"""Device resolution for the port's entry points.

Every entry point runs on the GPU unless the caller names another device.
Without a CUDA device the default raises instead of carrying on on the CPU:
a serving or timing path that silently lands on the CPU reports numbers of
the wrong machine.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the current CUDA device; anything else is taken as named.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device exists. Pass `device="cpu"` to run on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


def names_device(value, device: torch.device) -> bool:
    """Whether a `device` value ("0", 0, "cuda", "cuda:0", "cpu", a
    torch.device) names `device`; one without an index names any index."""
    text = str(value).strip().lower()
    try:
        want = torch.device("cuda", int(text)) if text.isdigit() else torch.device(text)
    except RuntimeError:
        return False
    if want.type != device.type:
        return False
    return want.index is None or device.index is None or want.index == device.index
