"""Sparse operators and their SpMV kernels (see the package docstring).

The package re-exports the names of gnnla_tpu/ops/__init__.py. Each is
imported from its module at first access (PEP 562), so importing the
package loads none of the operator modules: they import the model and
kernel modules, which import this package in turn.
"""

import importlib

_MODULES = {
    "sparse": ("SparseOperator",),
    "segment": ("segment_sum", "segment_mean", "segment_max", "segment_min",
                "segment_reduce", "multi_segment_reduce"),
    "band": ("BandLayout", "BandPattern", "EllLayout", "EllPattern",
             "GridBandLayout", "GridPattern", "choose_edge_layout",
             "band_multi_reduce", "band_neighbor_values", "band_spmv",
             "ell_multi_reduce"),
    "dia": ("DIAOperator", "to_dia", "dia_transpose"),
    "bsr": ("BSROperator", "to_bsr", "rcm_permutation", "permute"),
    "stream_op": ("StreamOperator", "stream_operator"),
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
