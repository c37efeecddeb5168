"""The reference's two-grid V-cycle in plain PyTorch: `runVCycle` of
Moore et al., Graph Neural Networks and Applied Linear Algebra
(sandialabs/gnn-applied-linear-algebra, pytorch/VCycle.py:175-237), with
its driver loop of cycles from x0 = 0 (:239-277).

It takes A (in the reference's own sign convention: the 5-point Laplacian
with diagonal -4 and off-diagonals +1) and a C/F splitting as data, and
builds the rest of the set-up itself in float64: the classical strength
of connection (`SOCClassicGNN`: v_i = max_{j != i} -A_ij, 0 on a row with
no off-diagonal, and j strong for i where -A_ij / v_i > theta), direct
interpolation (`DirectInterpGNN`: for a fine i and each coarse neighbour
j, w_ij = -A_ij alpha_i with alpha_i = (sum_{k != i} A_ik) / (A_ii
sum_{k != i} A_ik S_ik C_k), 0 where that is not finite; a coarse i
interpolates itself), P = (I + W)[:, coarse] with the coarse points in
index order, and the Galerkin product Ac = P^T (A P). Then it runs the
cycle as the reference writes it:

    n_pre sweeps  x <- x + omega D^-1 (b - A x)        D = diag(A)
    r = b - A x;  rc = P^T r
    xc = Chebyshev(Ac, rc, 0; c, d, degree)            (runCheby)
    x <- x + P xc
    n_post sweeps as above

Every product is the COO gather, multiply and scatter-add of
`reference/sparse.py`. The reference judges the program in float64. Given
a lower dtype, A's values are held in it, P is built from them in float64
and its values rounded once to it, Ac is the float64 product of those
values rounded once to it, and every vector is held in it: the control,
which the comparison has to refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.sparse import Reference


def _coo(rows, cols, vals, shape, device) -> torch.Tensor:
    idx = torch.stack([torch.as_tensor(np.asarray(rows, np.int64)),
                       torch.as_tensor(np.asarray(cols, np.int64))])
    v = torch.as_tensor(np.asarray(vals, np.float64))
    return torch.sparse_coo_tensor(idx, v, shape, device=device).coalesce()


def _held(vals, dtype) -> np.ndarray:
    """Values as `dtype` holds them, in float64."""
    v = torch.as_tensor(np.asarray(vals, np.float64))
    return v.to(dtype).double().numpy()


def galerkin(A: tuple, P: tuple, n: int, nc: int, device) -> torch.Tensor:
    """P^T (A P) in float64 as a coalesced sparse COO tensor, from COO
    triplets (rows, cols, vals) of A [n x n] and P [n x nc]."""
    a = _coo(*A, (n, n), device)
    p = _coo(*P, (n, nc), device)
    return torch.sparse.mm(p.t().coalesce(),
                           torch.sparse.mm(a, p)).coalesce()


def direct_interpolation(A: tuple, coarse, n: int, theta: float,
                         device) -> tuple:
    """P [n x nc] of classical strength (theta) and direct interpolation
    on A (rows, cols, vals) and the C/F flags `coarse` [n] (1 coarse),
    in float64: COO triplets as host arrays (int64, int64, float64)."""
    dev = torch.device(device)
    rows = torch.as_tensor(np.asarray(A[0], np.int64), device=dev)
    cols = torch.as_tensor(np.asarray(A[1], np.int64), device=dev)
    vals = torch.as_tensor(np.asarray(A[2], np.float64), device=dev)
    C = torch.as_tensor(np.asarray(coarse).reshape(-1) != 0,
                        device=dev).double()
    f64 = dict(device=dev, dtype=torch.float64)
    on = rows == cols
    diag = torch.zeros(n, **f64).index_add_(0, rows[on], vals[on])
    r, c, a = rows[~on], cols[~on], vals[~on]

    v = torch.full((n,), -torch.inf, **f64).scatter_reduce_(
        0, r, -a, reduce="amax")
    v[torch.isinf(v)] = 0.0
    strong = ((-a / v[r]) > theta).double()   # NaN (0 / 0) is not strong

    num = torch.zeros(n, **f64).index_add_(0, r, a)
    den = torch.zeros(n, **f64).index_add_(0, r, a * strong * C[c])
    alpha = num / den / diag
    w = torch.nan_to_num(-a * alpha[r], nan=0.0, posinf=0.0, neginf=0.0)

    cmap = torch.cumsum(C, 0).long() - 1
    fine_to_coarse = (C[r] == 0) & (C[c] == 1)
    ci = torch.nonzero(C == 1).reshape(-1)
    p_rows = torch.cat([r[fine_to_coarse], ci])
    p_cols = torch.cat([cmap[c[fine_to_coarse]], cmap[ci]])
    p_vals = torch.cat([w[fine_to_coarse], torch.ones(ci.numel(), **f64)])
    return tuple(t.cpu().numpy() for t in (p_rows, p_cols, p_vals))


class TwoGrid:
    """The reference cycle on A (reference convention, (rows, cols, vals)
    COO triplets) and the C/F flags `coarse`, with its own P and Ac, on
    `device` in `dtype`."""

    def __init__(self, A: tuple, coarse, n: int, device,
                 dtype=torch.float64, *, theta: float, n_pre: int,
                 n_post: int, omega: float, coarse_deg: int,
                 coarse_c: float, coarse_d: float):
        rows, cols = np.asarray(A[0]), np.asarray(A[1])
        vals = _held(A[2], dtype)
        p_rows, p_cols, p_vals = direct_interpolation(
            (rows, cols, vals), coarse, n, theta, device)
        p_vals = _held(p_vals, dtype)
        self.n = int(n)
        self.nc = int((np.asarray(coarse).reshape(-1) != 0).sum())
        nc = self.nc
        self.dtype = dtype
        self.device = torch.device(device)
        self.P_coo = (p_rows, p_cols, p_vals)
        self.A = Reference(rows, cols, vals, n, device, dtype)
        self.P = Reference(p_rows, p_cols, p_vals, n, device, dtype)
        self.Pt = Reference(p_cols, p_rows, p_vals, nc, device, dtype)
        self.Ac_product = galerkin((rows, cols, vals), self.P_coo, n, nc,
                                   device)
        ac_idx = self.Ac_product.indices().cpu().numpy()
        self.Ac = Reference(ac_idx[0], ac_idx[1],
                            self.Ac_product.values().cpu().numpy(), nc,
                            device, dtype)
        d = np.zeros(n)
        on = rows == cols
        np.add.at(d, rows[on], vals[on])
        self.diag = torch.from_numpy(d).to(device=device, dtype=dtype)
        self.n_pre, self.n_post, self.omega = n_pre, n_post, omega
        self.cheb = (coarse_c, coarse_d, coarse_deg)

    def _jacobi(self, b, x, sweeps: int):
        for _ in range(sweeps):
            x = x + self.omega * (b - self.A.matvec(x)) / self.diag
        return x

    def _chebyshev(self, b):
        """runCheby from x = 0: the recurrence of Chebyshev relaxation with
        the reference's k == 2 and k > 2 beta formulas."""
        c, d, deg = self.cheb
        x = torch.zeros_like(b)
        if deg <= 0:
            return x
        r = b - self.Ac.matvec(x)
        alpha = 1.0 / d
        p = r
        x = x + alpha * p
        for k in range(2, deg + 1):
            r = r - alpha * self.Ac.matvec(p)
            beta = 0.5 * (c * alpha) ** 2 if k == 2 else \
                ((c * alpha) / 2.0) ** 2
            alpha = 1.0 / (d - beta / alpha)
            p = r + beta * p
            x = x + alpha * p
        return x

    def cycle(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One V-cycle (runVCycle) on b and x in the reference's dtype."""
        x = self._jacobi(b, x, self.n_pre)
        rc = self.Pt.matvec(b - self.A.matvec(x))
        x = x + self.P.matvec(self._chebyshev(rc))
        return self._jacobi(b, x, self.n_post)

    def solve(self, b: torch.Tensor, n_cycles: int) -> torch.Tensor:
        """n_cycles cycles from x0 = 0 (the driver loop)."""
        b = b.to(device=self.device, dtype=self.dtype).reshape(-1)
        x = torch.zeros_like(b)
        for _ in range(n_cycles):
            x = self.cycle(b, x)
        return x

    def p_rel_err(self, P: tuple, shape) -> float:
        """max |P - P_ref| / max |P_ref| entry by entry over both patterns:
        P the set-up's prolongation as (rows, cols, vals) COO triplets of
        `shape`, P_ref this reference's own. inf where the shapes differ
        (another coarse grid)."""
        if tuple(int(s) for s in shape) != (self.n, self.nc):
            return float("inf")
        got = _coo(*P, (self.n, self.nc), self.device)
        want = _coo(*self.P_coo, (self.n, self.nc), self.device)
        err = float((got - want).coalesce().values().abs().max())
        return err / max(float(want.values().abs().max()), 1e-300)

    def galerkin_rel_err(self, v: torch.Tensor, y: torch.Tensor) -> float:
        """max |y - Ac v| / max |Ac v|: y the set-up's Ac applied to v (as
        the program's cycle applies it), Ac this reference's own P^T A P
        applied in the reference's dtype."""
        want = self.Ac.matvec(v).double()
        err = float((y.to(want.device).double() - want).abs().max())
        return err / max(float(want.abs().max()), 1e-300)
