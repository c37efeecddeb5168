"""Host-side AMG setup: splitting, interpolation, Galerkin product.

The package re-exports the names of gnnla_tpu/amg/__init__.py, each
imported from its module at first access (PEP 562), as `ops` does.
"""

import importlib

_MODULES = {
    "splitting": ("split", "split_cljp", "split_pmis", "split_alternating"),
    "interp": ("assemble_prolongation",),
    "galerkin": ("galerkin_product",),
}
_HOME = {name: mod for mod, names in _MODULES.items() for name in names}

__all__ = [name for names in _MODULES.values() for name in names]


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
