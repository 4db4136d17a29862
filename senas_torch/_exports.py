"""Lazy package exports: the names a package's `__init__` exports, each
imported from its module at first use, so that importing one submodule of
the port does not load the rest of the package."""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def lazy_exports(package: str, exports: Dict[str, str]) -> Callable[[str], object]:
    """A module `__getattr__` for `package`: `exports` maps each name to
    the module that defines it (a name whose module is `package.<name>`
    is that submodule itself)."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(exports[name])
        return module if module.__name__ == f"{package}.{name}" else getattr(module, name)

    return __getattr__
