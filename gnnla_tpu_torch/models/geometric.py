"""Geometric (semi-coarsened) two-grid cycle — the counterpart of
gnnla_tpu/models/geometric.py, the all-stencil path.

The alternating C/F splitting (coarse points = even columns) on a grid of
even width is semi-coarsening: the coarse grid is itself an (H, W/2)
grid, so every part of the cycle is regular:

  * pre/post smoothing and the fine residual run on kernel K4
    (`ops/stencil_kernel.py`: fused Jacobi sweeps, fused r = b - A x);
  * P and P^T never materialise: the direct-interpolation weights group
    by (dy, dj) offset class into dense [H, W/2] planes, and prolongation
    and restriction are multiplies and `torch.roll`s (plain PyTorch, as
    the JAX package runs them in XLA, outside Pallas);
  * the Galerkin Ac = P^T A P is again a stencil on the coarse grid, so
    every Ac apply of the coarse Chebyshev solve runs on K4 too.

The setup (SOC -> split -> direct interpolation -> Galerkin) is the same
host computation as `setup_twogrid(A, splitting="alternating")`, so the
cycle matches the generic `vcycle` on that setup to f32 rounding.

K4 launches per cycle with the defaults (n_pre = n_post = 3, coarse_deg
= 4): 3 (pre) + 1 (residual) + 4 (Ac applies) + 3 (post) = 11.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gnnla_tpu_torch.models.vcycle import TwoGridSetup, setup_twogrid
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stencil import stencil_taps
from gnnla_tpu_torch.ops.stencil_kernel import (StencilCall,
                                                make_stencil_jacobi,
                                                make_stencil_residual,
                                                taps_tensor)
from gnnla_tpu_torch.utils.program import program


def _interp_planes(P: SparseOperator, grid_shape: Tuple[int, int]):
    """Decompose the alternating-splitting prolongation into offset planes.

    Returns (offsets, planes): for an F-point at fine (r, c=2j+1),
    P[(r, c), (r', j')] lands in the class (dy, dj) = ((r'-r) mod H,
    (j'-j) mod Wc) with planes[k][r, j] holding the weight. C-point rows
    must be exactly the identity."""
    h, w = grid_shape
    wc = w // 2
    rows, cols, vals = P.host_coo()
    rf, cf = rows // w, rows % w
    rc_, jc = cols // wc, cols % wc
    is_c = (cf % 2) == 0
    if not (np.all(rf[is_c] == rc_[is_c])
            and np.all(cf[is_c] // 2 == jc[is_c])
            and np.allclose(vals[is_c], 1.0)):
        raise ValueError("C-point rows of P are not the identity; "
                         "was the setup built with splitting='alternating'?")
    m = ~is_c
    jf = (cf[m] - 1) // 2
    dy = (rc_[m] - rf[m]) % h
    dj = (jc[m] - jf) % wc
    cls = dy.astype(np.int64) * wc + dj
    uniq, k_idx = np.unique(cls, return_inverse=True)
    planes = np.zeros((uniq.size, h * wc), np.float64)
    np.add.at(planes, (k_idx, rf[m] * wc + jf), vals[m])
    offsets = [(int(u) // wc, int(u) % wc) for u in uniq]
    return offsets, planes.reshape(-1, h, wc)


class GeometricVCycle:
    """All-stencil two-grid cycle for grid operators (see module doc).

    cycle(b, x) is one cycle on flat [n] vectors, op by op; run(b, x) runs
    it as a program (`self.program`, the JAX `_jit_cycle`): on the card a
    captured graph, replayed after the first call. The JAX class threads
    its operator arrays through `cycle(args, b, x)` for its compiler; here
    every operator is bound to the object."""

    def __init__(self, A: SparseOperator, grid_shape, *, theta: float = 0.25,
                 n_pre: int = 3, n_post: int = 3, omega: float = 0.7,
                 coarse_deg: int = 4, coarse_c: float = -3.4,
                 coarse_d: float = -4.0, diag=None, tap_dtype=None,
                 setup: Optional[TwoGridSetup] = None):
        h, w = (int(g) for g in grid_shape)
        if w % 2:
            raise ValueError(f"grid width must be even, got {w} "
                             "(alternating splitting = even columns)")
        self.grid_shape = (h, w)
        self.wc = wc = w // 2
        if setup is None:
            setup = setup_twogrid(A, theta=theta, splitting="alternating",
                                  diag=diag)
        if not (isinstance(setup.A, SparseOperator)
                and isinstance(setup.P, SparseOperator)):
            raise ValueError(
                "GeometricVCycle needs a COO TwoGridSetup (its P assembly "
                "reads host COO triplets); construct it before "
                "setup_with_dia, not after")
        flags = setup.coarse_flags.cpu().numpy()
        want = np.zeros(h * w, flags.dtype)
        want[::2] = 1
        if not np.array_equal(flags, want):
            raise ValueError("setup's C/F splitting is not the alternating "
                             "pattern; build with splitting='alternating'")
        self.setup = setup
        self._coarse = dict(c=float(coarse_c), d=float(coarse_d),
                            deg=int(coarse_deg))
        device = A.device

        self._pre = make_stencil_jacobi(A, self.grid_shape, omega=omega,
                                        n_iters=n_pre, diag=setup.diag,
                                        tap_dtype=tap_dtype)
        self._post = self._pre if n_post == n_pre else make_stencil_jacobi(
            A, self.grid_shape, omega=omega, n_iters=n_post,
            diag=setup.diag, tap_dtype=tap_dtype)
        self._res = make_stencil_residual(A, self.grid_shape,
                                          tap_dtype=tap_dtype)

        self._p_offsets, p_planes = _interp_planes(setup.P, self.grid_shape)
        self._wplanes = torch.from_numpy(p_planes).float().to(device)

        ac_shifts, ac_planes = stencil_taps(setup.Ac, (h, wc))
        ac_dtype = tap_dtype or setup.Ac.vals.dtype
        self._ac_call = StencilCall(
            ac_shifts, taps_tensor(ac_planes, (h, wc), ac_dtype, device), 1,
            "plain")
        self.program = program(self.cycle)  # the JAX `_jit_cycle`

    def kernel_calls(self):
        """The distinct K4 calls of a cycle (their `launches` counters)."""
        calls = (self._pre._call, self._post._call, self._res._call,
                 self._ac_call)
        return list({id(c): c for c in calls}.values())

    # -- coarse-grid pieces ------------------------------------------------

    def _restrict(self, r2):
        """rc = P^T r: identity on C columns + rolled weighted F columns."""
        h, wc, wplanes = self.grid_shape[0], self.wc, self._wplanes
        rr = r2.reshape(h, wc, 2)
        re, ro = rr[..., 0], rr[..., 1]
        rc = re
        for k, (dy, dj) in enumerate(self._p_offsets):
            rc = rc + torch.roll(wplanes[k] * ro, (dy, dj), (0, 1))
        return rc

    def _prolong(self, xc):
        """P xc: C columns get xc, F columns the weighted stencil."""
        wplanes = self._wplanes
        odd = torch.zeros_like(xc)
        for k, (dy, dj) in enumerate(self._p_offsets):
            odd = odd + wplanes[k] * torch.roll(xc, (-dy, -dj), (0, 1))
        return torch.stack([xc, odd], dim=-1).reshape(self.grid_shape)

    def _cheby(self, b2, x2):
        """models.chebyshev's recurrence on 2-D arrays, Ac on K4."""
        c, d, deg = (self._coarse["c"], self._coarse["d"],
                     self._coarse["deg"])
        if deg <= 0:
            return x2

        mv = self._ac_call
        r = b2 - mv(x2)
        alpha = 1.0 / d
        p = r
        x2 = x2 + alpha * p
        for k in range(2, deg + 1):
            z = mv(p)
            r = r - alpha * z
            beta = (0.5 * (c * alpha) ** 2 if k == 2
                    else ((c * alpha) / 2.0) ** 2)
            alpha = 1.0 / (d - beta / alpha)
            p = r + beta * p
            x2 = x2 + alpha * p
        return x2

    # -- the cycle ---------------------------------------------------------

    def cycle(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One cycle on flat [n] vectors, op by op (capture-safe: the
        Chebyshev scalars are Python floats, baked in at capture as they
        are at trace time)."""
        b2 = b.reshape(self.grid_shape).float()
        x2 = self._pre.run(b2, x.reshape(self.grid_shape))

        rc = self._restrict(self._res.run(b2, x2))
        xc = self._cheby(rc, torch.zeros_like(rc))
        x2 = x2 + self._prolong(xc)

        return self._post.run(b2, x2).reshape(-1)

    def run(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One cycle on flat [n] vectors as a program (a captured graph
        on the card; see `utils/program.py`)."""
        return self.program(b.reshape(-1), x.reshape(-1))


def make_geometric_vcycle(A: SparseOperator, grid_shape,
                          **kwargs) -> GeometricVCycle:
    """Semi-coarsened all-stencil two-grid cycle (see GeometricVCycle)."""
    return GeometricVCycle(A, grid_shape, **kwargs)
