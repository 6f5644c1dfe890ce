"""Lazy package-level names (PEP 562): a package's `__init__.py` re-exports
the public names of its modules, as the JAX package's `__init__.py` files
do, but imports a module only when one of its names is first used, so that
importing a subpackage does not pull in the whole stack (the engine, the
trainer) and packages that import each other's modules (`cfg` and `utils`)
stay free of import cycles.

    __getattr__, __dir__, __all__ = lazy_exports(__name__, {"Conv": ".conv", ...})

Each name is the object of the module it maps to (relative to the
package), looked up at first use and then kept in the package's globals.
"""
from __future__ import annotations

import importlib
import sys
import types
from typing import Callable, Dict, Iterable, List, Mapping, Tuple

_ROOT = __name__.split(".")[0]


def lazy_exports(package: str, names: Mapping[str, str],
                 own: Iterable[str] = ()) -> Tuple[Callable, Callable, List[str]]:
    """(`__getattr__`, `__dir__`, `__all__`) for `package`, which re-exports
    `names`: {name: the module that defines it, relative to `package`}.
    `__all__` is `own` (names the package binds itself) and `names`."""
    names: Dict[str, str] = dict(names)

    def __getattr__(name: str):
        module = names.get(name)
        if module is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(module, package), name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__() -> List[str]:
        return sorted(set(vars(sys.modules[package])) | set(names))

    return __getattr__, __dir__, [*own, *names]


def own_names(namespace: Mapping[str, object]) -> List[str]:
    """The public names a module binds to the port's own objects: what
    `from module import *` gives without an `__all__`, less modules and
    the classes, functions and `typing` names of other libraries
    (`Path`, `Dict`, a `from __future__` feature)."""
    def foreign(v) -> bool:
        if isinstance(v, types.ModuleType):
            return True
        if isinstance(v, (type, types.FunctionType)):
            return v.__module__.split(".")[0] != _ROOT
        return type(v).__module__ in ("typing", "__future__")

    return [k for k, v in namespace.items() if not k.startswith("_") and not foreign(v)]
