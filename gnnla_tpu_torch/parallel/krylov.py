"""Distributed multilevel-preconditioned CG — the counterpart of
gnnla_tpu/parallel/krylov.py.

`models.krylov.mg_pcg` composed over a mesh: the CG vectors are this
rank's [R] blocks, the matvec is the halo-exchange sharded SpMV, the
preconditioner is one distributed multilevel cycle
(`make_sharded_multigrid_cycle`), and every inner product is a `psum` of
the ranks' local sums (where the JAX package lets XLA insert the psum).
The scalars stay on the device: the loop has no host synchronisation, and
the residual-norm history is fetched once after it.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.parallel.collectives import axis_group, psum
from gnnla_tpu_torch.parallel.spmv import ShardSpMV
from gnnla_tpu_torch.parallel.vcycle import make_sharded_multigrid_cycle


def make_sharded_mg_pcg(setup, mesh, axis: str = "rows", *,
                        n_smooth: int = 1, omega: float = 0.7,
                        coarse_deg: int = 8, flip_sign: bool = False,
                        min_sharded_rows: int = 32768,
                        n_sharded_levels=None, globalize=None):
    """Returns (solve, part): solve(b_local, x0_local, n_iters) ->
    (x_local, hist).

    b/x0 are this rank's [R] blocks of `part` (build them with
    `local_block(shard_vector(v, part), mesh)`); hist is the [n_iters]
    residual-norm history as host numpy, the same on every rank.
    `flip_sign=True` solves with the negated operator (the negative
    definite FD Laplacian convention), as `models.krylov.mg_pcg`.
    `globalize` is forwarded to `make_sharded_multigrid_cycle`."""
    cycle, part = make_sharded_multigrid_cycle(
        setup, mesh, axis, n_pre=n_smooth, n_post=n_smooth, omega=omega,
        coarse_deg=coarse_deg, min_sharded_rows=min_sharded_rows,
        n_sharded_levels=n_sharded_levels, globalize=globalize)
    mvec = ShardSpMV.on_mesh(part, mesh, axis)
    g = axis_group(mesh, axis)
    s = -1.0 if flip_sign else 1.0

    def dot(u, v):
        return psum(torch.sum(u * v), g)

    def solve(b, x0, n_iters: int):
        def matvec(v):
            return s * mvec(v)

        def precond(r):
            # the multilevel cycle from a zero guess with symmetric
            # smoothing: an SPD preconditioner, linear in the rhs
            return cycle(s * r, torch.zeros_like(r))

        b2 = s * b
        x = x0
        r = b2 - matvec(x)
        z = precond(r)
        p = z
        rz = dot(r, z)
        hist = []
        for _ in range(int(n_iters)):
            ap = matvec(p)
            denom = dot(p, ap)
            alpha = rz / torch.where(denom == 0, torch.ones_like(denom),
                                     denom)
            x = x + alpha * p
            r = r - alpha * ap
            z = precond(r)
            rz_new = dot(r, z)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p = z + beta * p
            rz = rz_new
            hist.append(torch.sqrt(dot(r, r)))
        hist = torch.stack(hist).cpu().numpy() if hist else \
            torch.zeros(0).numpy()
        return x, hist

    return solve, part
