"""Build helpers of the PyTorch port, and the JAX package's `utils`
constants and `colorstr` (`mgdt_yolo_tpu/utils/__init__.py:19-129`), built
from the port's own configuration (`cfg/default.CFG_DEFAULTS`, the literal
of JAX's `cfg/default.yaml`) and settings file (`utils/settings.py`).
`DEFAULT_CFG_PATH` names that literal's module, since the port reads no
YAML default file."""
from __future__ import annotations

import os
from pathlib import Path
from types import SimpleNamespace

from .. import _lazy
from ..cfg.default import CFG_DEFAULTS

PKG_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_CFG_PATH = PKG_ROOT / "cfg" / "default.py"
NUM_THREADS = min(8, max(1, (os.cpu_count() or 1) - 1))
LOGGING_NAME = "mgdt_yolo_tpu_torch"
RANK = int(os.getenv("RANK", -1))
USER_CONFIG_DIR = Path(os.getenv("MGDT_CONFIG_DIR", Path.home() / ".config" / "mgdt_yolo_tpu"))
SETTINGS_YAML = USER_CONFIG_DIR / "settings.yaml"

_COLORS = {"black": "\033[30m", "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
           "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
           "bold": "\033[1m", "underline": "\033[4m", "end": "\033[0m"}


def colorstr(*input) -> str:
    """A string wrapped in terminal colour codes, e.g. colorstr('blue',
    'hello'); bold blue where only the string is given."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    return "".join(_COLORS[x] for x in args) + f"{string}" + _COLORS["end"]


class IterableSimpleNamespace(SimpleNamespace):
    """A namespace that iterates over its (key, value) pairs and has `get`."""

    def __iter__(self):
        return iter(vars(self).items())

    def __str__(self):
        return "\n".join(f"{k}={v}" for k, v in vars(self).items())

    def get(self, key, default=None):
        return getattr(self, key, default)


DEFAULT_CFG_DICT = dict(CFG_DEFAULTS)
DEFAULT_CFG_KEYS = DEFAULT_CFG_DICT.keys()
DEFAULT_CFG = IterableSimpleNamespace(**DEFAULT_CFG_DICT)

# the JAX package's `utils` functions, kept in the port's own modules, each
# imported at first use (`settings` imports this package's `dataset_yaml`)
_LAZY = {**dict.fromkeys(("LOGGER", "set_logging", "yaml_save", "yaml_print", "get_settings",
                          "set_settings", "increment_path"), ".settings"),
         "yaml_load": ".dataset_yaml", "SimpleClass": "..engine.results"}
__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, _LAZY,
                                                   own=_lazy.own_names(globals()))
