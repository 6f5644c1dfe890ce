"""Checks of versions, image sizes and the environment: the counterparts of
the JAX package's `utils/checks.py` `check_version`, `check_imgsz`,
`check_suffix`, `check_requirements` (which, as JAX's, never installs
anything), `check_bf16` (float32 against bf16 on one seeded conv, on the
given device) and `check_yolo` (the `checks` command), the last reporting
what the port runs on: torch, CUDA and nvcc, the card's name and power
limit, and where the kernels are built."""
from __future__ import annotations

import importlib
import logging
import platform
import re
import subprocess
import sys
from pathlib import Path
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


def check_suffix(file: str, suffix: Union[str, tuple] = (".yaml",), msg: str = ""):
    """Raise ValueError where `file` has a suffix outside `suffix` (a file
    without one passes), as JAX's."""
    suffix = (suffix,) if isinstance(suffix, str) else tuple(suffix)
    s = Path(str(file)).suffix.lower()
    if s and s not in suffix:
        raise ValueError(f"{msg}{file} has unsupported suffix {s}; expected {suffix}")


def check_requirements(requirements=(), install: bool = False) -> bool:
    """Whether every requirement ("name>=1.0" or "name") imports; a warning
    names the missing ones. Nothing is ever installed, whatever `install`
    says, as in JAX."""
    missing = []
    for r in ([requirements] if isinstance(requirements, str) else requirements):
        name = re.split(r"[<>=!~]", r)[0].strip()
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(r)
    if missing:
        LOGGER.warning(f"WARNING missing requirements {missing} "
                       f"(auto-install disabled in this environment)")
    return not missing


def check_bf16(device=None) -> bool:
    """Whether bf16 arithmetic on `device` (the card by default) is sound:
    JAX's seeded 3x3 'same' conv ((1, 32, 32, 8) input from
    `default_rng(0)`, (3, 3, 8, 8) weight from `default_rng(1)` times 0.1)
    in float32 (TF32 off) and in bf16, the largest difference under 0.1 of
    the float32 output's largest magnitude."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ..device import resolve_device
    from .measure import float32_exact
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 32, 8))
                         .astype(np.float32)).permute(0, 3, 1, 2).to(dev)
    w = torch.from_numpy((np.random.default_rng(1).standard_normal((3, 3, 8, 8)) * 0.1)
                         .astype(np.float32)).permute(3, 2, 0, 1).to(dev)
    with torch.no_grad(), float32_exact():
        a = F.conv2d(x, w, padding=1)
        b = F.conv2d(x.bfloat16(), w.bfloat16(), padding=1).float()
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    ok = rel < 0.1
    if not ok:
        LOGGER.warning(f"bf16 check failed (rel err {rel:.3f}); training in fp32")
    return ok


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
