"""Checks of versions, image sizes and the environment: the counterparts of
the JAX package's `utils/checks.py` `check_version`, `check_imgsz` and
`check_yolo` (the `checks` command), the last reporting what the port runs
on: torch, CUDA and nvcc, the card's name and power limit, and where the
kernels are built."""
from __future__ import annotations

import logging
import platform
import re
import subprocess
import sys
from typing import List, Union

LOGGER = logging.getLogger(__name__)


def parse_version(v: str) -> tuple:
    """The first three numbers of a version string ('2.11.0+cu128' -> (2, 11, 0))."""
    return tuple(int(x) for x in re.findall(r"\d+", str(v))[:3] or [0])


def check_version(current: str, minimum: str, name: str = "version",
                  hard: bool = False) -> bool:
    """Whether `current` >= `minimum`; a warning where not, or with `hard`
    an AssertionError, as JAX's."""
    ok = parse_version(current) >= parse_version(minimum)
    if not ok:
        msg = f"{name} {minimum} required, found {current}"
        if hard:
            raise AssertionError(msg)
        LOGGER.warning(f"WARNING {msg}")
    return ok


def check_imgsz(imgsz: Union[int, List[int]], stride: int = 32,
                floor: int = 0) -> Union[int, List[int]]:
    """Round an image size up to a multiple of `stride` (at least `floor`),
    with a warning where it changed."""
    stride = int(stride)
    sizes = [imgsz] if isinstance(imgsz, int) else list(imgsz)
    new = [max(int(-(-x // stride) * stride), floor) for x in sizes]
    if new != sizes:
        LOGGER.warning(f"WARNING imgsz {sizes} not multiple of stride {stride}, "
                       f"updated to {new}")
    return new[0] if isinstance(imgsz, int) else new


def _nvcc_version() -> str:
    from .build import nvcc_path
    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"
    return out.strip().splitlines()[-1]


def check_yolo() -> str:
    """The environment report of the `checks` command (logged and
    returned): the package, Python, torch and its CUDA, nvcc, each card's
    name and power limit, and the kernels' build directory."""
    import torch

    from .. import __version__
    from .build import BUILD_DIR
    if torch.cuda.is_available():
        from .measure import gpu_name_and_power
        try:
            card = gpu_name_and_power()
        except (OSError, subprocess.SubprocessError) as e:
            card = f"{torch.cuda.get_device_name(0)} (power limit unavailable: {e})"
        cards = f"{torch.cuda.device_count()} x {card}"
    else:
        cards = "none (CUDA unavailable: pass device=cpu)"
    lines = [f"mgdt_yolo_tpu_torch {__version__}",
             f"python {sys.version.split()[0]} on {platform.platform()}",
             f"torch {torch.__version__}, CUDA {torch.version.cuda}",
             f"nvcc: {_nvcc_version()}",
             f"cards: {cards}",
             f"kernel build directory: {BUILD_DIR}"]
    msg = "\n".join(lines)
    LOGGER.info(msg)
    return msg
