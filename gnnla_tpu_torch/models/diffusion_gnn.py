"""Diffusion-coefficient recovery GNN: the learned encode-process-decode
stack — the counterpart of gnnla_tpu/models/diffusion_gnn.py.

The reference's LearnDiffusionCoeffs.py: full graph-network blocks with
learned MLP updates and 4-way (min, mean, sum, max) aggregations for
e->v, e->g and v->g.

  * inputs: v = [A_ii] (1), e = [A_ij, rel_x, rel_y] (3), g = [h] (1)
  * optional encoder: independent MLPs lift v, e and g to n_hidden
  * n_layers_external GN blocks; each update is an
    n_layers_internal-deep MLP of width n_hidden:
      edge MLP in   = [v_i, v_j, e, g]
      vertex MLP in = [v, 4-agg(e'), g]
      global MLP in = [g, 4-agg_e(e'), 4-agg_v(v')]
    (a single-external-layer net has no global update)
  * optional decoder: a vertex-only MLP to 2 outputs (alpha_i, beta_i)
  * the forward ends with LeakyReLU (slope 0.01)

Two execution paths share one parameter set: the edge-order path on the
GN-block engine (`core/block.py`), for a `SparseOperator`, and the
band-family path on `ops/band.py`'s `BandPattern`, `GridPattern` or
`EllPattern`, with no gather on the grid and band layouts. Submodules are
named as the JAX package's flax modules (`enc_vertex`, `gn0_edge`,
`dec_vertex`, ...), so `training/checkpoints.py` carries parameter trees
across. Flax infers input widths from the first call; here they are the
diffusion inputs' widths, `N_VERTEX_IN`, `N_EDGE_IN` and `N_GLOBAL_IN`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.core.block import GNBlock
from gnnla_tpu_torch.core.graph import GraphBatch, GraphState
from gnnla_tpu_torch.ops.band import BandPattern, EllPattern, GridPattern

_AGGS = ("min", "mean", "sum", "max")
# v = [A_ii], e = [A_ij, rel_x, rel_y], g = [h]
N_VERTEX_IN, N_EDGE_IN, N_GLOBAL_IN = 1, 3, 1
# flax's truncated-normal variance scaling divides the target standard
# deviation by the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class MLPStack(nn.Module):
    """n_layers-deep ReLU MLP n_in -> n_hidden ... -> n_out; one Linear
    when n_layers == 1 (the reference's getInitializedLinear path)."""

    def __init__(self, n_layers: int, n_in: int, n_hidden: int, n_out: int):
        super().__init__()
        dims = [n_in] + [n_hidden] * (n_layers - 1) + [n_out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x)


def _broadcast_globals(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """g [Fg], [B, Fg] or per-item [..., Fg] broadcast to like's leading
    shape: like.shape[:-1] + (Fg,)."""
    return g.expand(tuple(like.shape[:-1]) + (g.shape[-1],))


def _multi(agg, e: torch.Tensor) -> torch.Tensor:
    """The 4-way e->v aggregation of [E, F] edges, or of [E, B, F] (a batch
    of graphs on one pattern, folded into the aggregator's feature axis)
    -> [N, 4F] or [N, B, 4F]."""
    if e.ndim == 2:
        return agg.multi(_AGGS, e)
    n_e, b, f = e.shape
    out = agg.multi(_AGGS, e.reshape(n_e, b * f))       # [N, 4 * B * F]
    return out.reshape(-1, len(_AGGS), b, f).permute(0, 2, 1, 3).reshape(
        -1, b, len(_AGGS) * f)


class DiffusionGNN(nn.Module):
    """Encode-process-decode stack; forward returns per-vertex
    [alpha_i, beta_i].

    The parameters are drawn on the host from `generator` (a
    torch.Generator or an int seed; None: a fresh unseeded draw) as
    flax's Dense initialises them, lecun-normal truncated kernels and zero
    biases, and then moved to `device`."""

    def __init__(self, n_layers_external: int, n_layers_internal: int,
                 n_hidden: int = 32,
                 encoder: Optional[Tuple[int, int]] = None,
                 decoder: Optional[Tuple[int, int]] = None,
                 n_out_vertex: int = 2, *,
                 generator: Union[torch.Generator, int, None] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.n_layers_external = int(n_layers_external)
        self.n_layers_internal = int(n_layers_internal)
        self.n_hidden = int(n_hidden)
        self.encoder = None if encoder is None else tuple(encoder)
        self.decoder = None if decoder is None else tuple(decoder)
        self.n_out_vertex = int(n_out_vertex)
        hid = self.n_hidden
        fv, fe, fg = N_VERTEX_IN, N_EDGE_IN, N_GLOBAL_IN
        if self.encoder is not None:
            enc_l, enc_h = self.encoder
            self.enc_vertex = MLPStack(enc_l, fv, enc_h, hid)
            self.enc_edge = MLPStack(enc_l, fe, enc_h, hid)
            self.enc_global = MLPStack(enc_l, fg, enc_h, hid)
            fv = fe = fg = hid
        v_out_final = hid if self.decoder is not None else self.n_out_vertex
        internal = self.n_layers_internal
        for li in range(self.n_layers_external):
            v_out = v_out_final if li == self.n_layers_external - 1 else hid
            setattr(self, f"gn{li}_edge",
                    MLPStack(internal, 2 * fv + fe + fg, hid, hid))
            setattr(self, f"gn{li}_vertex",
                    MLPStack(internal, fv + len(_AGGS) * hid + fg, hid,
                             v_out))
            if self.n_layers_external > 1:
                setattr(self, f"gn{li}_global",
                        MLPStack(internal,
                                 fg + len(_AGGS) * (hid + v_out), hid, hid))
                fg = hid
            fv, fe = v_out, hid
        if self.decoder is not None:
            dec_l, dec_h = self.decoder
            self.dec_vertex = MLPStack(dec_l, fv, dec_h, self.n_out_vertex)
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """Redraw every Linear in registration order: kernels from the
        truncated lecun normal, biases 0."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        for lin in self.modules():
            if not isinstance(lin, nn.Linear):
                continue
            std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
            w = torch.empty(lin.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            lin.weight.copy_(w)
            lin.bias.zero_()

    def _mlps(self, li: int):
        return (getattr(self, f"gn{li}_edge"), getattr(self, f"gn{li}_vertex"),
                getattr(self, f"gn{li}_global", None))

    def _gn_layer(self, li: int) -> GNBlock:
        """GN layer li as a GNBlock of the edge-order engine. Edges may be
        [E, F] or [E, B, F], vertices [N, F] or [N, B, F]."""
        edge_mlp, vertex_mlp, global_mlp = self._mlps(li)

        def edge_fn(v_i, v_j, e, g):
            return edge_mlp(torch.cat(
                [v_i, v_j, e, _broadcast_globals(g, e)], dim=-1))

        def vertex_fn(v, e, agg, g):
            return vertex_mlp(torch.cat(
                [v, _multi(agg, e), _broadcast_globals(g, v)], dim=-1))

        def global_fn(v, e, g, vagg, eagg):
            return global_mlp(torch.cat(
                [g, eagg.multi(_AGGS, e), vagg.multi(_AGGS, v)], dim=-1))

        return GNBlock(edge_fn=edge_fn, vertex_fn=vertex_fn,
                       global_fn=global_fn if global_mlp is not None
                       else None)

    def _band_gn_apply(self, li: int, pat, v: torch.Tensor, e: torch.Tensor,
                       g: torch.Tensor):
        """GN layer li on a band-family pattern, batched: v [B, N, F],
        e [B, K, N, F], g [B, Fg]. v_i is a broadcast, v_j a shift, roll
        or gather, e->v the (masked) band reduction, e->g and v->g
        whole-graph reductions."""
        edge_mlp, vertex_mlp, global_mlp = self._mlps(li)
        v_i = pat.broadcast(v)
        v_j = pat.neighbor(v)
        g_e = g[:, None, None, :].expand(e.shape[:3] + (g.shape[-1],))
        e = pat.mask_pads(edge_mlp(torch.cat([v_i, v_j, e, g_e], dim=-1)))
        ebar = pat.multi(_AGGS, e)
        g_v = g[:, None, :].expand(v.shape[:2] + (g.shape[-1],))
        v = vertex_mlp(torch.cat([v, ebar, g_v], dim=-1))
        if global_mlp is not None:
            ebar_g = pat.global_multi(_AGGS, e)
            vbar_g = torch.cat([v.amin(dim=-2), v.mean(dim=-2),
                                v.sum(dim=-2), v.amax(dim=-2)], dim=-1)
            g = global_mlp(torch.cat([g, ebar_g, vbar_g], dim=-1))
        return v, e, g

    def forward(self, op, state: GraphState,
                batch: Optional[GraphBatch] = None) -> torch.Tensor:
        """op: a `SparseOperator` (edge-order path) or a `BandPattern` /
        `GridPattern` / `EllPattern` (band-family path). State layouts:

          edge path, one graph      v [N, Fv], e [E, Fe], g [Fg]
          edge path, one pattern    v [B, N, Fv], e [B, E, Fe], g [B, Fg]
          edge path, `batch` given  block-diagonal GraphBatch, g [G, Fg]
          band path                 v [(B,) N, Fv], e [(B,) K, N, Fe],
                                    g [(B,) Fg]

        Returns the leaky-ReLU'd vertex outputs in the layout of v."""
        banded = isinstance(op, (BandPattern, GridPattern, EllPattern))
        v, e, g = state.vertices, state.edges, state.globals_
        single = v.ndim == 2 and batch is None
        if banded and single:
            v, e, g = v[None], e[None], g[None]
        stacked = not banded and v.ndim == 3  # one pattern, batch middle
        if stacked:
            v, e = v.transpose(0, 1), e.transpose(0, 1)

        if self.encoder is not None:
            e = self.enc_edge(e)
            if banded:  # re-zero pad slots (the lift has a bias)
                e = op.mask_pads(e)
            v, g = self.enc_vertex(v), self.enc_global(g)

        for li in range(self.n_layers_external):
            if banded:
                v, e, g = self._band_gn_apply(li, op, v, e, g)
            else:
                out = self._gn_layer(li)(
                    op, GraphState(vertices=v, edges=e, globals_=g), batch)
                v, e, g = out.vertices, out.edges, out.globals_

        if self.decoder is not None:
            v = self.dec_vertex(v)
        v = F.leaky_relu(v, 0.01)
        if stacked:
            return v.transpose(0, 1)
        return v[0] if banded and single else v


def init_diffusion_gnn(generator, model: DiffusionGNN) -> dict:
    """Redraw `model`'s parameters from `generator` (a torch.Generator or
    an int seed) and return them as a state dict. The input widths come
    from the model's constructor, where flax reads them off a first
    call."""
    model.reset_parameters(generator)
    return model.state_dict()
