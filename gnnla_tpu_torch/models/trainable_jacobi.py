"""Trainable Jacobi diagonal: a vertex-only learned GN block — the
counterpart of gnnla_tpu/models/trainable_jacobi.py.

Per vertex the input is [A_ii, min/mean/sum/max of the off-diagonal row]
(5 features); an MLP 5 -> 50 -> 20 -> 1 with ReLU maps it to the learned
D_i, which replaces A_ii in the Jacobi smoother (x <- x + omega (b - Ax)
/ D). The reference's init, weights U[0, 1) and biases 0.01, is the
default; `init_scheme="lecun"` is flax's default Dense init.

Flax's Dense keeps its kernel as [in, out]; `nn.Linear` keeps [out, in].
`training/checkpoints.py::params_from_jax` carries the JAX package's
parameter trees across.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
from torch import nn

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.core.block import make_edge_aggregator
from gnnla_tpu_torch.ops.band import band_multi_reduce

REDUCERS = ("min", "mean", "sum", "max")
INIT_SCHEMES = ("reference", "lecun")
# flax's truncated-normal variance scaling divides the target standard
# deviation by the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def jacobi_diag_features(op_nodiag, diag: torch.Tensor) -> torch.Tensor:
    """[N, 5] vertex features: A_ii + (min, mean, sum, max) of the
    off-diagonal row, through `make_edge_aggregator` (the dense row layout
    for fixed patterns)."""
    agg = make_edge_aggregator(op_nodiag, op_nodiag.n_rows)
    aggregated = agg.multi(REDUCERS, op_nodiag.vals[:, None])
    return torch.cat([diag.reshape(-1)[:, None], aggregated], dim=1)


def jacobi_diag_features_banded(diag: torch.Tensor, band_ov: torch.Tensor,
                                mask: torch.Tensor, deg: torch.Tensor
                                ) -> torch.Tensor:
    """`jacobi_diag_features` on the gather-free band layout
    (ops/band.py): band_ov [K, N] (off-diagonal values packed by
    `BandLayout.pack`) with diag [N] gives [N, 5]; a batch, band_ov
    [B, K, N] with diag [B, N], gives [B, N, 5] (the batch rides the
    reducers' feature axis). mask [K, N] and deg [N] from the layout."""
    if band_ov.ndim == 2:
        aggregated = band_multi_reduce(REDUCERS, band_ov, mask, deg)
        return torch.cat([diag.reshape(-1)[:, None], aggregated], dim=1)
    b = band_ov.shape[0]
    aggregated = band_multi_reduce(REDUCERS, band_ov.permute(1, 2, 0),
                                   mask, deg)             # [N, 4 * B]
    aggregated = aggregated.reshape(-1, len(REDUCERS), b).permute(2, 0, 1)
    return torch.cat([diag[..., None], aggregated], dim=-1)


class TrainableJacobiMLP(nn.Module):
    """The vertex-update MLP phi^v: Linear layers of `widths` with ReLU
    between them, [..., n_features] -> [..., widths[-1]].

    The parameters are drawn on the host from `generator` (a
    torch.Generator, or an int seed; None: a fresh unseeded draw) and then
    moved to `device`."""

    def __init__(self, widths: Sequence[int] = (50, 20, 1),
                 init_scheme: str = "reference", n_features: int = 5, *,
                 generator: Union[torch.Generator, int, None] = None,
                 device="cuda"):
        super().__init__()
        if init_scheme not in INIT_SCHEMES:
            raise ValueError(f"init_scheme must be one of {INIT_SCHEMES}, "
                             f"got {init_scheme!r}")
        device = resolve_device(device)
        self.widths = tuple(int(w) for w in widths)
        self.init_scheme = init_scheme
        dims = (int(n_features),) + self.widths
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        for lin in self.layers:
            w = torch.empty(lin.weight.shape)
            if self.init_scheme == "reference":
                w.uniform_(0.0, 1.0, generator=generator)
                b = torch.full(lin.bias.shape, 0.01)
            else:
                std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                b = torch.zeros(lin.bias.shape)
            lin.weight.copy_(w)
            lin.bias.copy_(b)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        h = features
        for lin in self.layers[:-1]:
            h = torch.relu(lin(h))
        return self.layers[-1](h)


def init_params(generator: Union[torch.Generator, int, None] = None,
                n_features: int = 5, widths=(50, 20, 1),
                init_scheme: str = "reference") -> dict:
    """A fresh MLP's parameters as a state dict on the host."""
    return TrainableJacobiMLP(widths, init_scheme, n_features,
                              generator=generator, device="cpu").state_dict()


def predict_diag(params, op_nodiag, diag: torch.Tensor, widths=(50, 20, 1),
                 init_scheme: str = "reference") -> torch.Tensor:
    """The learned D as [N]. `params` is a TrainableJacobiMLP or its state
    dict (then loaded into a new MLP on diag's device)."""
    model = params
    if not isinstance(params, TrainableJacobiMLP):
        model = TrainableJacobiMLP(widths, init_scheme, device=diag.device)
        model.load_state_dict(params)
    return model(jacobi_diag_features(op_nodiag, diag)).reshape(-1)
