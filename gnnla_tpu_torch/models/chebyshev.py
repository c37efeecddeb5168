"""Chebyshev relaxation (degree-d semi-iteration) — the counterpart of
gnnla_tpu/models/chebyshev.py.

GN-block form: two blocks per iteration, the recurrences in the global
updates (state v = [b, x, r, p], e = [A_ij, z_ij], g = [c, d, alpha,
beta]):

  iteration 1: z_ij = A_ij x_j ; r = b - zbar ; alpha = 1/d ; p = r ;
               x += alpha p
  iteration 2: z_ij = A_ij p_j ; r -= alpha_old zbar ;
               beta = 0.5 (c alpha_old)^2 ; alpha = 1/(d - beta/alpha_old) ;
               p = r + beta p ; x += alpha p
  later:       the same with beta = ((c alpha_old)/2)^2

The vertex update consumes the old alpha before the global update
refreshes it. The fused form runs the same recurrence on the operator's
matvec, with the scalars in Python floats; on an operator with a
one-launch form of it (K1's Chebyshev form, `DiaKernelOperator.chebyshev`,
on a level small enough for one CUDA block) it hands the whole recurrence
to that launch, which gives the same bits.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.utils.program import count

# Every `chebyshev` call, and those of them that ran as one launch of the
# operator's Chebyshev form (through `count`, so a graph's replays add
# theirs)
CHEB_TALLY = SimpleNamespace(calls=0, one_launch=0)

_B, _X, _R, _P = 0, 1, 2, 3  # vertex feature columns


def _edge_ax(col):
    """Edge update z_ij = A_ij * (v_j[col]); keeps A_ij in slot 0."""
    def fn(v_i, v_j, e, g):
        a_ij = e[:, :1]
        return torch.cat([a_ij, a_ij * v_j[:, col:col + 1]], dim=1)
    return fn


def _iter1_vertex(v, e, agg, g):
    b = v[:, _B]
    r = b - agg.sum(e[:, 1])
    return torch.stack([b, v[:, _X], r], dim=1)


def _iter1_global(v, e, g, vagg, eagg):
    c, d = g[0], g[1]
    return torch.stack([c, d, 1.0 / d])


def _iter1_layer2_vertex(v, e, agg, g):
    b, x, r = v[:, _B], v[:, _X], v[:, _R]
    p = r
    x = x + g[2] * p
    return torch.stack([b, x, r, p], dim=1)


def _later_vertex(v, e, agg, g):
    b, x, r, p = v[:, _B], v[:, _X], v[:, _R], v[:, _P]
    r = r - g[2] * agg.sum(e[:, 1])  # old alpha: the global runs after
    return torch.stack([b, x, r, p], dim=1)


def _beta_global(beta_fn):
    def fn(v, e, g, vagg, eagg):
        c, d, alpha = g[0], g[1], g[2]
        beta = beta_fn(c, alpha)
        alpha = 1.0 / (d - beta / alpha)
        return torch.stack([c, d, alpha, beta])
    return fn


def _later_layer2_vertex(v, e, agg, g):
    b, x, r, p = v[:, _B], v[:, _X], v[:, _R], v[:, _P]
    p = r + g[3] * p
    x = x + g[2] * p
    return torch.stack([b, x, r, p], dim=1)


def _build_layers(deg: int):
    iter1 = [
        GNBlock(edge_fn=_edge_ax(_X), vertex_fn=_iter1_vertex,
                global_fn=_iter1_global),
        GNBlock(vertex_fn=_iter1_layer2_vertex),
    ]
    iter2 = [
        GNBlock(edge_fn=_edge_ax(_P), vertex_fn=_later_vertex,
                global_fn=_beta_global(lambda c, a: 0.5 * (c * a) ** 2)),
        GNBlock(vertex_fn=_later_layer2_vertex),
    ]
    later = [
        GNBlock(edge_fn=_edge_ax(_P), vertex_fn=_later_vertex,
                global_fn=_beta_global(lambda c, a: ((c * a) / 2.0) ** 2)),
        GNBlock(vertex_fn=_later_layer2_vertex),
    ]
    layers = []
    if deg > 0:
        layers.extend(iter1)
    if deg > 1:
        layers.extend(iter2)
    for _ in range(deg - 2):
        layers.extend(later)
    return layers


def chebyshev_gnn(op: SparseOperator, b: torch.Tensor, x: torch.Tensor, *,
                  c: float, d: float, deg: int) -> torch.Tensor:
    """The explicit GN-block form; returns the relaxed x."""
    state = GraphState(
        vertices=torch.stack([b.reshape(-1), x.reshape(-1)], dim=1),
        edges=torch.stack([op.vals, torch.zeros_like(op.vals)], dim=1),
        globals_=op.vals.new_tensor([c, d]))
    for layer in _build_layers(deg):
        state = layer(op, state)
    return state.vertices[:, _X]


def chebyshev_scalars(c: float, d: float, deg: int):
    """(alpha_1 .. alpha_deg, beta_2 .. beta_deg) of the degree-`deg`
    recurrence, in Python floats (same k == 2 and k > 2 beta formulas as
    the JAX package)."""
    alpha = 1.0 / d
    alphas, betas = [alpha], []
    for k in range(2, deg + 1):
        beta = 0.5 * (c * alpha) ** 2 if k == 2 else ((c * alpha) / 2.0) ** 2
        alpha = 1.0 / (d - beta / alpha)
        alphas.append(alpha)
        betas.append(beta)
    return alphas, betas


def chebyshev(op, b: torch.Tensor, x: torch.Tensor, *, c: float, d: float,
              deg: int) -> torch.Tensor:
    """Degree-`deg` Chebyshev recurrence on fused SpMVs, with the scalars
    of `chebyshev_scalars`.

    An operator with a one-launch form of the recurrence (K1's
    `chebyshev`) runs it as one launch, with the same bits, where it
    takes the vectors, the shape and the degree (`takes_chebyshev`)."""
    b, x = b.reshape(-1), x.reshape(-1)
    count(CHEB_TALLY, "calls")
    if deg <= 0:
        return x
    alphas, betas = chebyshev_scalars(c, d, deg)
    if hasattr(op, "takes_chebyshev") and op.takes_chebyshev(b, x, deg):
        count(CHEB_TALLY, "one_launch")
        return op.chebyshev(b, x, alphas, betas)
    r = b - op.matvec(x)
    p = r
    x = x + alphas[0] * p
    for k in range(1, deg):
        z = op.matvec(p)
        r = r - alphas[k - 1] * z
        p = r + betas[k - 1] * p
        x = x + alphas[k] * p
    return x
