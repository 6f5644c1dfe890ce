"""The configuration and the command line: the counterpart of the JAX
package's `mgdt_yolo_tpu/cfg/__init__.py`.

`get_cfg` merges the configuration in JAX's cascade, default
(`cfg.default.CFG_DEFAULTS`) < `cfg` < overrides, and holds it to JAX's
rules: an unknown key raises `SyntaxError` with close matches
(`check_dict_alignment`), a value of the wrong type or range `TypeError` or
`ValueError` (`check_cfg_types`). `entrypoint` is the command line,
`python -m mgdt_yolo_tpu_torch TASK MODE key=value ...`, parsed as JAX's
`entrypoint` parses it, which builds a `YOLO` facade and calls the mode's
method; the special commands (`help`, `checks`, `version`, `settings`,
`cfg`, `copy-cfg`) print instead. YAML files are read by
`utils/dataset_yaml.py` and written by `utils/settings.py` (no PyYAML).
"""
from __future__ import annotations

import ast
import contextlib
import difflib
import logging
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Mapping, Union

from .. import _lazy
from .default import (CFG_BOOL_KEYS, CFG_DEFAULTS, CFG_FLOAT_KEYS, CFG_FRACTION_KEYS,
                      CFG_INT_KEYS)

# the package's logger (`utils.settings.LOGGER`), as JAX's `cfg` logs
# through its `utils.LOGGER`
LOGGER = logging.getLogger("mgdt_yolo_tpu_torch")
TASKS = ("detect", "segment", "classify", "pose")
MODES = ("train", "val", "predict", "export", "track", "benchmark")


def cfg2dict(cfg: Union[str, Path, Dict, SimpleNamespace]) -> Dict:
    """A configuration given as a YAML file, a dict or a namespace, as a dict."""
    if isinstance(cfg, (str, Path)):
        from ..utils.dataset_yaml import yaml_load
        cfg = yaml_load(cfg)
    elif isinstance(cfg, SimpleNamespace):
        cfg = vars(cfg)
    return cfg


def check_cfg_types(cfg: Mapping) -> None:
    """Raise where a value has the wrong type for its key group, as the JAX
    `cfg.check_cfg_types` does (a copy of its rules)."""
    for k, v in cfg.items():
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS and not isinstance(v, (int, float)):
            raise TypeError(f"'{k}={v}' must be a number (got {type(v).__name__})")
        elif k in CFG_FRACTION_KEYS:
            if not isinstance(v, (int, float)):
                raise TypeError(f"'{k}={v}' must be a number (got {type(v).__name__})")
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"'{k}={v}' must be in [0, 1]")
        elif k in CFG_INT_KEYS and not isinstance(v, int):
            raise TypeError(f"'{k}={v}' must be an int (got {type(v).__name__})")
        elif k in CFG_BOOL_KEYS and not isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be a bool (got {type(v).__name__})")


def check_dict_alignment(base: Mapping, custom: Mapping) -> None:
    """Raise `SyntaxError` with close matches where a key of `custom` is not
    in `base`, as the JAX `cfg.check_dict_alignment` does."""
    mismatched = [k for k in custom if k not in base]
    if mismatched:
        msgs = []
        for k in mismatched:
            matches = difflib.get_close_matches(k, list(base))
            hint = f"Similar keys: {matches}. " if matches else ""
            msgs.append(f"'{k}' is not a valid config key. {hint}")
        raise SyntaxError("\n".join(msgs))


def get_cfg(cfg: Union[str, Path, Dict, SimpleNamespace, None] = None,
            overrides: Union[str, Path, Dict, None] = None) -> SimpleNamespace:
    """The merged, checked configuration: `CFG_DEFAULTS` < `cfg` (its
    configuration keys and `save_dir`) < `overrides`."""
    cfg = cfg2dict(cfg) if cfg is not None else dict(CFG_DEFAULTS)
    merged = dict(CFG_DEFAULTS)
    merged.update({k: v for k, v in cfg.items() if k in CFG_DEFAULTS or k == "save_dir"})
    if overrides:
        overrides = cfg2dict(overrides)
        check_dict_alignment(dict(merged, save_dir=None), overrides)
        merged.update(overrides)
    for k in ("project", "name"):
        if isinstance(merged.get(k), (int, float)):
            merged[k] = str(merged[k])
    check_cfg_types(merged)
    return SimpleNamespace(**merged)


CLI_HELP_MSG = f"""usage: python -m mgdt_yolo_tpu_torch TASK MODE key=value ...

    TASK (optional): one of {TASKS}
    MODE (required): one of {MODES}
    key=value: any config override, e.g. imgsz=320 model=yolov8n.yaml device=cpu

    Special commands:
        python -m mgdt_yolo_tpu_torch help        show this message
        python -m mgdt_yolo_tpu_torch checks      environment / device report
        python -m mgdt_yolo_tpu_torch version     package version
        python -m mgdt_yolo_tpu_torch settings    show persistent settings (reset | k=v to edit)
        python -m mgdt_yolo_tpu_torch cfg         print the default config
        python -m mgdt_yolo_tpu_torch copy-cfg    copy the default config here for customizing

    Counting over a folder of labelled images:
        python -m mgdt_yolo_tpu_torch.utils.counting MODEL IMG_DIR [--metrics]
"""


def merge_equals_args(args):
    """Join fragments around a lone '=': ['imgsz', '=', '640'], ['imgsz=',
    '640'] and ['imgsz', '=640'] all become ['imgsz=640']."""
    merged = []
    for a in args:
        if a == "=" and merged:
            merged[-1] += "="
        elif a.startswith("=") and merged:
            merged[-1] += a
        elif merged and merged[-1].endswith("="):
            merged[-1] += a
        else:
            merged.append(a)
    return merged


def _smart_value(v: str):
    """A command-line value: none/true/false in any case, else a Python
    literal where it parses as one, else the string."""
    low = v.lower()
    if low == "none":
        return None
    if low in ("true", "false"):
        return low == "true"
    with contextlib.suppress(ValueError, SyntaxError):
        return ast.literal_eval(v)
    return v


def handle_yolo_settings(args) -> None:
    """`settings [reset | key=value ...]`: print, reset or edit the
    persistent settings (`utils/settings.py`)."""
    from ..utils.settings import get_settings, set_settings, settings_file, yaml_print
    if args and args[0] == "reset":
        settings_file().unlink(missing_ok=True)
        settings = get_settings()
        LOGGER.info("settings reset to defaults")
    elif args:
        kv = {}
        for a in merge_equals_args(args):
            if "=" not in a:
                raise SyntaxError(
                    f"settings argument {a!r} needs 'key=value' form, e.g. "
                    f"'settings {a}=/path' ('settings' alone prints current values, "
                    f"'settings reset' restores defaults)")
            k, v = a.split("=", 1)
            kv[k] = None if v.lower() == "null" else _smart_value(v)
        settings = set_settings(kv)
    else:
        settings = get_settings()
    yaml_print(settings)


def copy_default_cfg() -> Path:
    """Write the default configuration to `default_copy.yaml` here, the
    file name the JAX `copy-cfg` gives its copy."""
    from ..utils.settings import yaml_save
    new_file = yaml_save(Path.cwd() / "default_copy.yaml", CFG_DEFAULTS)
    LOGGER.info(f"the default configuration was written to {new_file}: use it with "
                f"'cfg={new_file} imgsz=320'")
    return new_file


def entrypoint(argv=None):
    """The command line, `TASK MODE key=value ...` plus the special
    commands, parsed as the JAX `entrypoint` parses it. Builds
    `YOLO(model, device=device)` (model `yolov8n.yaml` by default) and
    returns what the mode's method returns."""
    import sys
    args = list(argv if argv is not None else sys.argv[1:])
    if not args:
        LOGGER.info(CLI_HELP_MSG)
        return

    from .. import __version__
    from ..utils.checks import check_yolo
    from ..utils.settings import yaml_print
    special = {
        "help": lambda: LOGGER.info(CLI_HELP_MSG),
        "checks": check_yolo,
        "version": lambda: LOGGER.info(__version__),
        "settings": lambda: handle_yolo_settings(args[1:]),
        "cfg": lambda: yaml_print(CFG_DEFAULTS),
        "copy-cfg": copy_default_cfg}
    full_args_dict = {**CFG_DEFAULTS, **{k: None for k in TASKS},
                      **{k: None for k in MODES}, **special}
    # singular and dashed aliases: -h, --help, check, setting, ...
    special.update({k[0]: v for k, v in special.items()})
    special.update({k[:-1]: v for k, v in special.items()
                    if len(k) > 1 and k.endswith("s")})
    special = {**special, **{f"-{k}": v for k, v in special.items()},
               **{f"--{k}": v for k, v in special.items()}}

    overrides = {}
    task = mode = None
    for a in merge_equals_args(args):
        if a.startswith("--"):
            LOGGER.warning(f"'{a}' does not need leading dashes, using '{a[2:]}'")
            a = a[2:]
        if a.endswith(","):
            a = a[:-1]
        if "=" in a:
            k, v = a.split("=", 1)
            if not v:
                raise SyntaxError(f"missing value for '{k}='")
            if k == "cfg":  # a YAML file of overrides
                LOGGER.info(f"overriding defaults with {v}")
                overrides.update({kk: vv for kk, vv in cfg2dict(v).items() if kk != "cfg"})
                continue
            overrides[k] = _smart_value(v)
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        elif a.lower() in special:
            special[a.lower()]()
            return
        elif a in CFG_DEFAULTS and isinstance(CFG_DEFAULTS[a], bool):
            overrides[a] = True  # a bare bool key: 'show' -> show=True
        elif a in CFG_DEFAULTS:
            raise SyntaxError(f"'{a}' is a valid key but needs an '=' sign, "
                              f"e.g. '{a}={CFG_DEFAULTS[a]}'")
        else:
            check_dict_alignment(full_args_dict, {a: ""})
    check_dict_alignment(full_args_dict, {k: v for k, v in overrides.items()
                                          if k != "save_dir"})

    mode = mode or overrides.pop("mode", "predict")
    if task:
        overrides["task"] = task
    from ..engine.model import YOLO
    model = YOLO(overrides.pop("model", None) or "yolov8n.yaml",
                 device=overrides.get("device"))
    if mode in ("predict", "track") and "source" not in overrides:
        import numpy as np
        LOGGER.warning(f"'source' is missing: using a synthetic grey image for {mode} "
                       f"(pass source=path)")
        overrides["source"] = np.full((640, 640, 3), 114, np.uint8)
    if mode == "benchmark":  # benchmark() takes these keys only
        overrides = {k: v for k, v in overrides.items()
                     if k in ("imgsz", "batch", "data", "formats")}
    out = getattr(model, mode)(**overrides)
    if mode == "predict" and isinstance(out, list):
        for r in out:
            if r.probs is not None:
                LOGGER.info(f"{r.path}: {r.verbose()}")
            else:
                LOGGER.info(f"{r.path}: {len(r)} detections {r.counts()} "
                            f"({r.speed['inference']:.1f} ms inference)")
    elif mode == "track" and isinstance(out, list):
        for r in out:
            ids = [] if r.boxes is None or r.boxes.id is None else r.boxes.id.astype(int).tolist()
            LOGGER.info(f"{r.path}: {len(r)} tracks {ids}")
    elif isinstance(out, dict):
        LOGGER.info(str(out))
    return out


# the JAX package's `cfg` names kept in `utils` (its `from ..utils import`),
# each imported at first use: `utils` imports `cfg.default`
_LAZY = {**dict.fromkeys(("DEFAULT_CFG_DICT", "DEFAULT_CFG_KEYS", "IterableSimpleNamespace",
                          "colorstr"), "..utils"),
         "yaml_load": "..utils.dataset_yaml"}
__getattr__, __dir__, __all__ = _lazy.lazy_exports(__name__, _LAZY,
                                                   own=_lazy.own_names(globals()))
