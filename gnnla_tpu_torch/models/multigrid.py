"""Multilevel AMG V/W-cycles — the counterpart of
gnnla_tpu/models/multigrid.py.

The reference composes exactly two grids (pytorch/VCycle.py:175-237); the
recursive hierarchy applies the same setup level by level until the
coarsest grid is small, then runs V- (or W-) cycles over all of it. Two
setups: `setup_multigrid` (classical splitting + direct interpolation per
level) and `setup_sa_multigrid` (smoothed aggregation, the scalable one).
Setup is host numpy/scipy; the operators land on the fine operator's
device. `multigrid_solve` iterates cycles in a Python loop (the JAX
package's `lax.scan`).

Fast path: `setup_with_dia_multigrid(setup, kernel=True)` puts every level
that `to_dia` accepts on kernel K1 (the DIA SpMV) — the function the JAX
package's DIA levels compute in XLA — and every other level and every
prolongation on kernel K2 (the CSR SpMV), where the JAX package keeps the
COO gathers and scatter-adds that XLA runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

from gnnla_tpu_torch.models.chebyshev import chebyshev
from gnnla_tpu_torch.models.jacobi import jacobi
from gnnla_tpu_torch.models.residual import residual
from gnnla_tpu_torch.models.vcycle import setup_twogrid
from gnnla_tpu_torch.ops.dia_spmv import dia_twin
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stream_op import (rect_stream_operator,
                                           stream_operator)
from gnnla_tpu_torch.utils.program import span, stage


@dataclasses.dataclass(frozen=True)
class MultigridSetup:
    """Hierarchy of fixed-pattern operators on one device.

    As    : operators per level (len L; finest first)
    Ps    : prolongations between levels (len L-1): COO, or K2 twins
    diags : smoother diagonals per level (len L; level 0 may be a trained
            Jacobi diagonal)
    coarse_c, coarse_d : the coarsest Chebyshev interval, from the
            coarsest operator's spectrum at setup (the reference's fixed
            c=-3.4, d=-4.0 bound only the finest Laplacian)
    """

    As: Tuple[Any, ...]
    Ps: Tuple[Any, ...]
    diags: Tuple[torch.Tensor, ...]
    coarse_c: float = -3.4
    coarse_d: float = -4.0

    @property
    def n_levels(self) -> int:
        return len(self.As)


def _host_diag(op: SparseOperator) -> torch.Tensor:
    """diag(op) from the host COO, in op's dtype on op's device."""
    np_dtype = torch.empty((), dtype=op.vals.dtype).numpy().dtype
    return torch.from_numpy(op.host_diagonal().astype(np_dtype)).to(
        op.device)


def _coarse_interval(op: SparseOperator) -> Tuple[float, float]:
    """(c, d) of the coarsest Chebyshev solve from the operator's real
    eigenvalue range (host dense eig: the coarsest grid is small)."""
    evals = np.linalg.eigvals(np.asarray(op.to_scipy().todense()))
    lmin, lmax = float(np.min(evals.real)), float(np.max(evals.real))
    return 0.5 * max(lmax - lmin, 1e-12), 0.5 * (lmax + lmin)


def setup_multigrid(A: SparseOperator, *, theta: float = 0.25,
                    splitting: str = "pmis", seed: int = 0,
                    min_coarse: int = 16, max_levels: int = 12,
                    trunc: float = 0.2, interp: str = "signed",
                    diag: Optional[torch.Tensor] = None) -> MultigridSetup:
    """Recursive AMG setup: `setup_twogrid` per level until the coarsest
    operator is small or coarsening stalls (coarse size >= 0.95 of the
    fine). The defaults are the robust multilevel ones (PMIS, signed
    direct interpolation, Ruge-Stuben truncation 0.2 at every level);
    `setup_twogrid`'s defaults mirror the reference's two-grid instead.
    `diag` (a trained Jacobi diagonal) applies to the finest level only."""
    As, Ps, diags = [], [], []
    current, d = A, diag
    for _ in range(max_levels - 1):
        if current.n_rows <= min_coarse:
            break
        tg = setup_twogrid(current, theta=theta, splitting=splitting,
                           seed=seed, diag=d, trunc=trunc, interp=interp)
        if tg.Ac.n_rows >= 0.95 * current.n_rows or tg.Ac.n_rows == 0:
            break
        As.append(current)
        Ps.append(tg.P)
        diags.append(tg.diag)
        current, d = tg.Ac, None
    As.append(current)
    diags.append(_host_diag(current))
    c, dd = _coarse_interval(current)
    return MultigridSetup(As=tuple(As), Ps=tuple(Ps), diags=tuple(diags),
                          coarse_c=c, coarse_d=dd)


def setup_sa_multigrid(A: SparseOperator, *, theta: float = 0.08,
                       seed: int = 0, min_coarse: int = 16,
                       max_levels: int = 12,
                       diag: Optional[torch.Tensor] = None) -> MultigridSetup:
    """Smoothed-aggregation AMG setup (Vanek/Mandel/Brezina): per level
    the SA strength at theta * 0.5^level, Vanek aggregation, the
    tentative prolongator smoothed by one damped-Jacobi step, and the
    Galerkin product — scipy in float64, each P and Ac cast once to A's
    dtype in the JAX package's entry order (`coalesce=False`). Each step
    is a stage (`utils/program.py`): `sa.to_host`, `sa.strength`,
    `sa.aggregate`, `sa.prolongator`, `sa.galerkin`, `sa.to_device` per
    level, and `sa.coarse_interval`."""
    from gnnla_tpu_torch.amg.aggregation import (aggregate, sa_strength,
                                                 smoothed_prolongator,
                                                 tentative_prolongator)

    As, Ps, diags = [], [], []
    current, d = A, diag
    dtype, device = A.vals.dtype, A.device
    for level in range(max_levels - 1):
        n = current.n_rows
        if n <= min_coarse:
            break
        with stage("sa.to_host"):
            Ah = current.to_scipy().tocsr()
        with stage("sa.strength"):
            S = sa_strength(Ah, theta * (0.5 ** level))
        with stage("sa.aggregate"):
            agg = aggregate(S, seed=seed)
            n_agg = int(agg.max()) + 1
        if n_agg >= 0.95 * n or n_agg < 1:
            break
        with stage("sa.prolongator"):
            P_hat = tentative_prolongator(agg)
            P = smoothed_prolongator(Ah, S, P_hat, seed=seed)
        with stage("sa.galerkin"):
            Ac = (P.T @ Ah @ P).tocsr()
            Ac.sum_duplicates()
            Ac.sort_indices()
        with stage("sa.to_device"):
            P = P.tocsr()
            P.sum_duplicates()
            P.sort_indices()
            Pc = P.tocoo()
            As.append(current)
            Ps.append(SparseOperator.from_coo(Pc.row, Pc.col, Pc.data,
                                              P.shape, dtype=dtype,
                                              coalesce=False, device=device))
            diags.append(_host_diag(current) if d is None
                         else torch.as_tensor(d, device=device).reshape(-1))
            d = None
            Acc = Ac.tocoo()
            current = SparseOperator.from_coo(Acc.row, Acc.col, Acc.data,
                                              Ac.shape, dtype=dtype,
                                              coalesce=False, device=device)
    As.append(current)
    with stage("sa.to_device"):
        diags.append(_host_diag(current))
    with stage("sa.coarse_interval"):
        c, dd = _coarse_interval(current)
    return MultigridSetup(As=tuple(As), Ps=tuple(Ps), diags=tuple(diags),
                          coarse_c=c, coarse_d=dd)


def setup_with_dia_multigrid(setup: MultigridSetup, max_offsets: int = 512,
                             kernel: bool = False) -> MultigridSetup:
    """Swap every level's operator for its DIA twin when banded enough
    (`to_dia` refuses more than `max_offsets` diagonals; such a level
    keeps COO). `kernel=True` puts each DIA level on kernel K1
    (`DiaKernelOperator`), as `setup_with_dia(kernel=True)` does for the
    two-grid setup, and the rest on kernel K2 in their own order: each
    level `to_dia` refused as a forward-only `StreamOperator` (the cycle
    only applies A; no CSR of A^T is kept, so its rmatvec raises), each
    prolongation as a `RectStreamOperator` (CSRs of P and P^T). Each
    level's DIA layout is the stage `dia.layout`, each K2 twin's the
    stage `k2.layout`."""
    on_dia = stage("dia.layout")(dia_twin)

    @stage("k2.layout")
    def on_k2(twin, op):
        return twin(op)

    def swap(twin, ops):
        return tuple(on_k2(twin, op) if isinstance(op, SparseOperator)
                     else op for op in ops)

    As = tuple(on_dia(a, max_offsets, kernel) for a in setup.As)
    if not kernel:
        return dataclasses.replace(setup, As=As)
    return dataclasses.replace(
        setup, As=swap(functools.partial(stream_operator, reorder=False,
                                         transpose=False), As),
        Ps=swap(lambda p: rect_stream_operator(p, p.n_cols), setup.Ps))


def multigrid_cycle(setup: MultigridSetup, b: torch.Tensor, x: torch.Tensor,
                    *, n_pre: int = 3, n_post: int = 3, omega: float = 0.7,
                    coarse_deg: int = 8, coarse_c: Optional[float] = None,
                    coarse_d: Optional[float] = None,
                    gamma: int = 1) -> torch.Tensor:
    """One multilevel cycle (gamma=1: V-cycle, gamma=2: W-cycle): Jacobi
    pre-smoothing, gamma coarse corrections (restrict the residual with
    P^T, recurse from zero, prolong), Jacobi post-smoothing; the coarsest
    level is a degree-`coarse_deg` Chebyshev solve. The cycle is the span
    `mg.cycle`, each visit of level l the span `mg.level<l>` (inclusive
    of the deeper levels; `utils/program.py`)."""
    b, x = b.reshape(-1), x.reshape(-1)
    coarse_c = setup.coarse_c if coarse_c is None else coarse_c
    coarse_d = setup.coarse_d if coarse_d is None else coarse_d
    opts = (n_pre, n_post, omega, coarse_deg, coarse_c, coarse_d, gamma)
    with span("mg.cycle"):
        return _cycle_level(setup, 0, b, x, opts)


def _cycle_level(setup: MultigridSetup, level: int, b: torch.Tensor,
                 x: torch.Tensor, opts: tuple) -> torch.Tensor:
    """Level `level` of `multigrid_cycle` and the levels below it. A
    module function and not a closure that calls itself: such a closure
    is a reference cycle holding `setup` until the cyclic collector runs,
    and a dropped hierarchy is freed at once."""
    n_pre, n_post, omega, coarse_deg, coarse_c, coarse_d, gamma = opts
    with span("mg.level", level):
        A, d = setup.As[level], setup.diags[level]
        if level == setup.n_levels - 1:
            return chebyshev(A, b, x, c=coarse_c, d=coarse_d, deg=coarse_deg)
        x = jacobi(A, b, x, omega=omega, n_iters=n_pre, diag=d)
        P = setup.Ps[level]
        for _ in range(gamma):
            rc = P.rmatvec(residual(A, b, x))
            xc = _cycle_level(setup, level + 1, rc, torch.zeros_like(rc),
                              opts)
            x = x + P.matvec(xc)
        return jacobi(A, b, x, omega=omega, n_iters=n_post, diag=d)


def multigrid_solve(setup: MultigridSetup, b: torch.Tensor, x: torch.Tensor,
                    *, n_cycles: int, **cycle_kwargs) -> torch.Tensor:
    """n_cycles multilevel cycles."""
    b, x = b.reshape(-1), x.reshape(-1)
    for _ in range(n_cycles):
        x = multigrid_cycle(setup, b, x, **cycle_kwargs)
    return x
