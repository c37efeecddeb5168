"""Two-grid AMG V-cycle — the counterpart of gnnla_tpu/models/vcycle.py.

AMG setup runs once on the host (`setup_twogrid`: strength of connection,
C/F splitting, direct interpolation, Galerkin product) and returns a
`TwoGridSetup` of fixed-pattern operators on one device; `vcycle` is then
Jacobi pre-smoothing, restriction of the residual, a Chebyshev coarse
solve, prolongation of the correction and Jacobi post-smoothing. `solve`
iterates cycles in a Python loop (the JAX package's `lax.scan`).

Fast path: `setup_with_dia(setup, kernel=True)` puts A and Ac on kernel
K1 (the DIA SpMV) and `setup_with_stream_p` puts P and P^T on kernel K2
(the CSR SpMV). Every solver only uses the matvec/rmatvec/diagonal
protocol, so the same `vcycle` runs on either path.

`setup_from_numpy` builds a setup from plain numpy arrays — the way a
setup made elsewhere (for instance by the JAX package, or one carrying a
trained Jacobi diagonal) is carried across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.amg.galerkin import galerkin_product
from gnnla_tpu_torch.amg.interp import assemble_prolongation
from gnnla_tpu_torch.amg.splitting import split
from gnnla_tpu_torch.models.chebyshev import chebyshev
from gnnla_tpu_torch.models.jacobi import jacobi
from gnnla_tpu_torch.models.residual import residual
from gnnla_tpu_torch.ops.dia import DIAOperator, to_dia
from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stream_op import rect_stream_operator


@dataclasses.dataclass(frozen=True)
class TwoGridSetup:
    """Fixed-pattern artifacts of the AMG setup phase, on one device."""

    A: Any    # SparseOperator | DIAOperator | DiaKernelOperator
    P: Any    # SparseOperator | RectStreamOperator
    Ac: Any   # SparseOperator | DIAOperator | DiaKernelOperator
    diag: torch.Tensor          # diag(A) — or a trained Jacobi diagonal
    coarse_flags: torch.Tensor  # [N] 1/0


def _soc_classic_host(rows, cols, vals, n, theta):
    """Classical strength of connection on the host (same empty-row
    semantics as the JAX twin: max over an empty row is 0). Returns the
    boolean strength mask per edge."""
    v = np.full(n, -np.inf, dtype=np.float64)
    np.maximum.at(v, rows, -vals)
    v[np.isneginf(v)] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        s = -vals / v[rows] - theta
    return np.nan_to_num(s, nan=-1.0, posinf=np.inf) > 0


def _direct_interp_host(rows, cols, vals, diag, coarse, strong):
    """Direct interpolation weights: w_ij = (1-C_i) * (-A_ij * alpha_i),
    alpha_i = (sum_k A_ik / sum_k A_ik S_ik C_k) / A_ii."""
    n = diag.shape[0]
    num = np.zeros(n, dtype=np.float64)
    den = np.zeros(n, dtype=np.float64)
    np.add.at(num, rows, vals)
    np.add.at(den, rows, vals * strong * coarse[cols])
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = (num / den) / diag
        w = (1.0 - coarse[rows]) * (-vals * alpha[rows])
    # C rows contribute nothing; F rows with no strong C neighbour neither
    return np.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)


def _direct_interp_host_signed(rows, cols, vals, diag, coarse, strong):
    """Stuben's signed direct interpolation (safe on non-M-matrices):
    positive off-diagonals are lumped into the diagonal, alpha uses the
    negative sums only, and rows are normalised by sign(diag) first. It
    reduces to `_direct_interp_host` on M-matrices."""
    n = diag.shape[0]
    sgn = np.where(diag < 0, -1.0, 1.0)
    vals = vals * sgn[rows]
    diag = diag * sgn
    neg = vals < 0
    keep = neg & (strong > 0)
    num = np.zeros(n, dtype=np.float64)
    den = np.zeros(n, dtype=np.float64)
    pos_sum = np.zeros(n, dtype=np.float64)
    np.add.at(num, rows, np.where(neg, vals, 0.0))
    np.add.at(den, rows, np.where(keep & (coarse[cols] > 0), vals, 0.0))
    np.add.at(pos_sum, rows, np.where(neg, 0.0, vals))
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = (num / den) / (diag + pos_sum)
        w = (1.0 - coarse[rows]) * np.where(keep, -vals * alpha[rows], 0.0)
    return np.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)


def setup_twogrid(A: SparseOperator, *, theta: float = 0.25,
                  splitting: str = "cljp", seed: int = 0,
                  diag: Optional[torch.Tensor] = None,
                  use_device_gnn: bool = False,
                  trunc: float = 0.0,
                  interp: str = "reference") -> TwoGridSetup:
    """AMG setup on the host: SOC -> C/F split -> direct interpolation ->
    Galerkin product. The operators land on A's device.

    `diag` substitutes a trained Jacobi diagonal for the smoother.
    interp="reference" is the reference formula, interp="signed" the
    Stuben variant for non-M-matrices. `use_device_gnn=True` (SOC and
    interpolation through the GN-block kernels) comes with the GN-block
    slice."""
    import scipy.sparse as sp

    if use_device_gnn:
        raise NotImplementedError(
            "use_device_gnn=True runs SOC and direct interpolation through "
            "the GN-block engine, which comes with the GN-block slice")
    device = A.device
    A_nodiag = A.remove_diagonal()
    diag_h = A.host_diagonal()
    if diag is None:
        a_diag = torch.from_numpy(diag_h).to(A.vals.dtype).to(device)
    else:
        a_diag = torch.as_tensor(diag, device=device).reshape(-1)
    rows, cols, vals = A_nodiag.host_coo()

    strong = _soc_classic_host(rows, cols, vals, A.n_rows, theta)
    S_host = sp.coo_matrix(
        (strong.astype(np.float64), (rows, cols)), shape=A.shape).tocsr()
    coarse = split(S_host, method=splitting, seed=seed)

    interp_fn = {"reference": _direct_interp_host,
                 "signed": _direct_interp_host_signed}[interp]
    w_ij = interp_fn(rows, cols, vals, diag_h, coarse.astype(np.float64),
                     strong.astype(np.float64))
    P = assemble_prolongation(A_nodiag, coarse, w_ij, dtype=A.vals.dtype,
                              trunc=trunc)
    Ac = galerkin_product(A, P)
    return TwoGridSetup(A=A, P=P, Ac=Ac, diag=a_diag,
                        coarse_flags=torch.from_numpy(coarse).to(device))


def setup_from_numpy(d: Mapping[str, Any], device="cuda") -> TwoGridSetup:
    """A TwoGridSetup from plain numpy arrays (e.g. an `np.load`ed .npz):

      {A,P,Ac}_rows, {A,P,Ac}_cols, {A,P,Ac}_vals  COO triplets
      {A,P,Ac}_shape                              (n_rows, n_cols)
      diag                                        [n] Jacobi diagonal —
                                                  diag(A) or a trained one
      coarse_flags                                [n] 1/0

    The operators are the plain COO ones; apply `setup_with_dia` /
    `setup_with_stream_p` for the kernel path."""
    device = resolve_device(device)

    def op(name):
        shape = tuple(int(s) for s in np.asarray(d[f"{name}_shape"]))
        return SparseOperator.from_coo(d[f"{name}_rows"], d[f"{name}_cols"],
                                       d[f"{name}_vals"], shape,
                                       device=device)

    return TwoGridSetup(
        A=op("A"), P=op("P"), Ac=op("Ac"),
        diag=torch.from_numpy(
            np.array(d["diag"], np.float32).reshape(-1)).to(device),
        coarse_flags=torch.from_numpy(
            np.array(d["coarse_flags"], np.int64).reshape(-1)).to(device))


def setup_with_dia(setup: TwoGridSetup, max_offsets: int = 512,
                   kernel: bool = False) -> TwoGridSetup:
    """Swap A (and Ac when banded enough) for DIA twins. `kernel=True`
    additionally puts both levels on kernel K1 (`DiaKernelOperator`), the
    counterpart of the JAX package's `pallas=True`. P stays as it is
    (rectangular; see `setup_with_stream_p`)."""
    def try_dia(op):
        if isinstance(op, SparseOperator):
            try:
                op = to_dia(op, max_offsets)
            except ValueError:
                return op  # too irregular — keep the COO path
        if kernel and isinstance(op, DIAOperator):
            op = dia_kernel_operator(op)
        return op

    return dataclasses.replace(setup, A=try_dia(setup.A),
                               Ac=try_dia(setup.Ac))


def setup_with_stream_p(setup: TwoGridSetup) -> TwoGridSetup:
    """Swap the prolongation P for its kernel-K2 twin
    (`RectStreamOperator`: P and P^T as CSRs). Keeps the COO P exactly
    where the JAX package's packer refuses the pattern (ValueError), so
    composing with any setup is safe."""
    P = setup.P
    if not isinstance(P, SparseOperator):
        return setup  # already swapped
    try:
        P_s = rect_stream_operator(P, P.n_cols)
    except ValueError:
        return setup  # refused pattern — keep the COO path
    return dataclasses.replace(setup, P=P_s)


def vcycle(setup: TwoGridSetup, b: torch.Tensor, x: torch.Tensor, *,
           n_pre: int = 3, n_post: int = 3, omega: float = 0.7,
           coarse_deg: int = 4, coarse_c: float = -3.4,
           coarse_d: float = -4.0) -> torch.Tensor:
    """One two-grid cycle. Defaults reproduce the reference (VCycle.py):
    w=0.7 Jacobi smoothing, degree-4 Chebyshev coarse solve with c=-3.4,
    d=-4.0."""
    A, P, Ac = setup.A, setup.P, setup.Ac
    b, x = b.reshape(-1), x.reshape(-1)

    x = jacobi(A, b, x, omega=omega, n_iters=n_pre, diag=setup.diag)

    r = residual(A, b, x)
    rc = P.rmatvec(r)
    xc = chebyshev(Ac, rc, torch.zeros_like(rc), c=coarse_c, d=coarse_d,
                   deg=coarse_deg)
    x = x + P.matvec(xc)

    return jacobi(A, b, x, omega=omega, n_iters=n_post, diag=setup.diag)


def solve(setup: TwoGridSetup, b: torch.Tensor, x: torch.Tensor, *,
          n_cycles: int, **cycle_kwargs) -> torch.Tensor:
    """Run n_cycles V-cycles."""
    b, x = b.reshape(-1), x.reshape(-1)
    for _ in range(n_cycles):
        x = vcycle(setup, b, x, **cycle_kwargs)
    return x
