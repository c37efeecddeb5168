"""Sparse operators and their SpMV kernels (see the package docstring)."""
