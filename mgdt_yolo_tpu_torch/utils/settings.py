"""Persistent settings, flat YAML output and run directories, without PyYAML
(the card's host has none): the counterparts of the JAX package's
`utils.yaml_save`, `yaml_print`, `get_settings`, `set_settings` and
`increment_path`.

The settings file is the JAX package's (`$MGDT_CONFIG_DIR/settings.yaml`,
by default `~/.config/mgdt_yolo_tpu/settings.yaml`) with its keys and
defaults, so a file written by either package's CLI reads the same in the
other. `yaml_dumps` writes a flat mapping of scalars that PyYAML's safe
loader and the port's reader (`utils/dataset_yaml.py`) both read back to
the same values: a string is written plain where the reader gives it back
as that string, else double-quoted (a JSON string, which is also a YAML
one); floats carry a dot, as PyYAML's dumper writes them.
"""
from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import sys
import uuid
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Mapping

from .dataset_yaml import _Error, _scalar, yaml_load

LOGGER = logging.getLogger("mgdt_yolo_tpu_torch")
SETTINGS_VERSION = "0.0.3"
# characters that may not start a plain scalar
_INDICATORS = tuple("-?:,[]{}#&*!|>'\"%@`")


class _StdoutHandler(logging.StreamHandler):
    """A handler that writes to whatever `sys.stdout` is when it writes."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


def set_logging() -> logging.Logger:
    """Print the package's INFO records to stdout, as the JAX package's
    logger does (called by the command-line entry points, not on import)."""
    if not any(isinstance(h, _StdoutHandler) for h in LOGGER.handlers):
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        LOGGER.addHandler(handler)
    LOGGER.setLevel(logging.INFO)
    return LOGGER


def _yaml_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # 1e-05 -> 1.0e-05: YAML 1.1 reads a float only with a dot
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, Path):
        v = str(v)
    if not isinstance(v, str):
        raise TypeError(f"yaml_dumps writes scalars, not {type(v).__name__}: {v!r}")
    try:
        plain = (v and v == v.strip() and not v.startswith(_INDICATORS) and "\n" not in v
                 and _scalar(v, 0, v) == v)
    except _Error:
        plain = False
    return v if plain else json.dumps(v, ensure_ascii=False)


def yaml_dumps(data: Mapping) -> str:
    """A flat mapping of scalars as YAML text, one `key: value` line each."""
    return "".join(f"{k}: {_yaml_scalar(v)}\n" for k, v in data.items())


def yaml_save(file, data: Mapping | None = None) -> Path:
    """Write a flat mapping to a YAML file, creating its directory."""
    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    file.write_text(yaml_dumps(data or {}), encoding="utf-8")
    return file


def yaml_print(data) -> None:
    """Log a flat mapping (or namespace) as YAML."""
    LOGGER.info(yaml_dumps(vars(data) if isinstance(data, SimpleNamespace) else data))


def settings_file() -> Path:
    """`$MGDT_CONFIG_DIR/settings.yaml`, by default under
    `~/.config/mgdt_yolo_tpu`, read when called."""
    return Path(os.getenv("MGDT_CONFIG_DIR", Path.home() / ".config" / "mgdt_yolo_tpu")) \
        / "settings.yaml"


def default_settings() -> Dict[str, Any]:
    """The JAX package's settings defaults, rooted at the working directory."""
    root = Path.cwd()
    return {"datasets_dir": str(root / "datasets"), "weights_dir": str(root / "weights"),
            "runs_dir": str(root / "runs"),
            "uuid": hashlib.sha256(str(uuid.getnode()).encode()).hexdigest(),
            "sync": False, "api_key": "", "settings_version": SETTINGS_VERSION}


def get_settings(file=None) -> Dict[str, Any]:
    """The persistent settings, written with the defaults on first use; a
    file whose keys or value types are not the defaults' is reset to them,
    as the JAX `get_settings` does."""
    file = Path(file) if file else settings_file()
    defaults = default_settings()
    if not file.exists():
        yaml_save(file, defaults)
        return defaults
    settings = yaml_load(file)
    correct = (settings and settings.keys() == defaults.keys()
               and all(type(settings[k]) is type(defaults[k]) for k in defaults))
    if not correct:
        LOGGER.warning(f"settings reset to defaults: view or update them with "
                       f"'settings' or at '{file}'")
        settings = defaults
        yaml_save(file, settings)
    return settings


def set_settings(kwargs: Mapping, file=None) -> Dict[str, Any]:
    """Update and write the persistent settings; an unknown key raises
    KeyError."""
    file = Path(file) if file else settings_file()
    settings = get_settings(file)
    unknown = set(kwargs) - set(settings)
    if unknown:
        raise KeyError(f"unknown settings keys {sorted(unknown)}; "
                       f"valid keys: {sorted(settings)}")
    settings.update(kwargs)
    yaml_save(file, settings)
    return settings


def increment_path(path, exist_ok: bool = False) -> Path:
    """`path`, or where it exists (and not `exist_ok`) the first free
    `path2`, `path3`, ... (runs/detect/train -> runs/detect/train2)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = Path(f"{path}{n}{suffix}")
            if not p.exists():
                return p
    return path
