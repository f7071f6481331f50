"""Lazy re-exports for the package's ``__init__`` files: a name loads its
module at first use, so importing a subpackage loads no kernel and pulls
in no other subpackage."""

from __future__ import annotations

import importlib


def lazy(package: str, exports: dict[str, str]):
    """(__getattr__, __dir__) of `package` for {name: submodule}."""
    def getattr_(name: str):
        if name in exports:
            module = importlib.import_module(f"{package}.{exports[name]}")
            return getattr(module, name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    def dir_():
        return sorted(exports)

    return getattr_, dir_
