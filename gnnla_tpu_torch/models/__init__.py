"""Solver compositions: residual, Jacobi, Chebyshev and the two-grid
V-cycle (the fused forms)."""
