"""The diffusion-coefficient trainer — the counterpart of
gnnla_tpu/training/train_diffusion.py.

The reference's recipe (DiffCoeffs/train.py:53-186): `DiffusionGNN` with
loss = MSE + max(relu(-pred)) (a positivity penalty), Adam at lr 1e-2
with a reduce-on-plateau scale, early stopping after `patience` epochs
without a better validation loss, the best parameters kept.

A batch is a slice of one pattern bucket on the production path, the
stencil-class `GridPattern` of `ops/band.py` (K = 8 mask-free classes with
roll neighbour reads), or whichever layout `choose_edge_layout` picks for
another pattern; the edge-order path (`make_apply`) serves the evaluation
tools. numpy's generator is consumed in the JAX package's order (the split
permutation, then each epoch's batch order), so both packages train on the
same batches. The optimizer is torch's Adam scaled by
`train_jacobi.PlateauScale` (optax's `contrib.reduce_on_plateau`), fed the
previous epoch's validation loss at every step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.core.graph import GraphState
from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
from gnnla_tpu_torch.ops.band import choose_edge_layout
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.parallel.collectives import pmax, psum
from gnnla_tpu_torch.training.checkpoints import CheckpointManager
from gnnla_tpu_torch.training.data_parallel import DataParallel
from gnnla_tpu_torch.training.datasets import (StackedGraphs,
                                               cosine_diffusion_dataset,
                                               periodic_rel_coords)
from gnnla_tpu_torch.training.train_jacobi import PlateauScale, train_step


@dataclasses.dataclass
class TrainDiffusionConfig:
    num_matrices: int = 1000
    n_mesh: int = 32            # the reference trains at 80-100
    max_freq: float = 3.0
    convection: Optional[Tuple[float, float]] = None  # e.g. (0.1, 0.0)
    n_layers_external: int = 1
    n_layers_internal: int = 3
    n_hidden: int = 64
    encoder: Optional[Tuple[int, int]] = None   # e.g. (3, 16)
    decoder: Optional[Tuple[int, int]] = None
    epochs: int = 200
    batch_size: int = 64
    lr: float = 1e-2
    seed: int = 41
    patience: int = 20
    split: Tuple[float, float, float] = (0.7, 0.2, 0.1)
    cache_dir: Optional[str] = "data_cache"
    checkpoint_dir: Optional[str] = None
    log_every: int = 1
    # data-parallel training over the ranks of an initialized process
    # group of this size (see `train`'s mesh)
    n_devices: Optional[int] = None


def edge_features(ds: StackedGraphs, n_mesh: int) -> np.ndarray:
    """[E, 2] periodic relative coordinates shared by the bucket."""
    return periodic_rel_coords(ds.template_nodiag, n_mesh)


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(op: SparseOperator, device: torch.device) -> SparseOperator:
    """op's pattern and values on `device` (op itself if already there)."""
    if op.device == device:
        return op
    rows, cols, vals = op.host_coo()
    return SparseOperator.from_coo(rows, cols, vals, op.shape,
                                   coalesce=False, device=device)


def make_apply(model: DiffusionGNN, ds: StackedGraphs, rel: np.ndarray):
    """Batched forward on the edge-order path (the GN-block engine):
    apply(offdiag_vals [B, E], diags [B, N], g [B, 1]) -> [B, N, 2], float32
    tensors on the model's device. Same parameters as `make_apply_banded`;
    kept for the evaluation tools, which hold edge-order data."""
    dev = _model_device(model)
    template = _on(ds.template_nodiag, dev)
    template.row_layout()
    rel_t = torch.from_numpy(np.asarray(rel, np.float32)).to(dev)

    def apply(ov, d, g):
        e = torch.cat([ov[..., None],
                       rel_t.expand(ov.shape + (rel_t.shape[-1],))], dim=-1)
        state = GraphState(vertices=d[..., None], edges=e, globals_=g)
        return model(template, state)

    return apply


def make_apply_banded(model: DiffusionGNN, ds: StackedGraphs,
                      rel: np.ndarray, grid_shape=None):
    """(apply, pack) on the zero-gather band layout (ops/band.py), the
    production path. With `grid_shape=(h, w)` and a uniform periodic
    pattern (every diffusion FEM bucket) the layout is the stencil-class
    `GridPattern`; other patterns go through `choose_edge_layout` (band or
    ELL; a requested grid that does not fit warns).

    apply(ov_bands [B, K, N], diags [B, N], g [B, 1]) -> [B, N, 2], float32
    tensors on the model's device; pack(offdiag_vals [..., E]) ->
    [..., K, N] on the host, once per split."""
    dev = _model_device(model)
    lay, pat, _kind = choose_edge_layout(_on(ds.template_nodiag, dev),
                                         grid_shape=grid_shape)
    # the static rel-coord planes in band order: [E, 2] -> [K, N, 2]
    rel_b = torch.from_numpy(np.moveaxis(lay.pack(np.ascontiguousarray(
        np.asarray(rel, np.float32).T)), 0, -1).copy()).to(dev)

    def apply(ovb, d, g):
        e = torch.cat([ovb[..., None],
                       rel_b.expand(ovb.shape + (rel_b.shape[-1],))], dim=-1)
        state = GraphState(vertices=d[..., None], edges=e, globals_=g)
        return model(pat, state)

    return apply, lay.pack


def loss_terms(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """MSE + the positivity penalty max(relu(-pred)) (reference
    train.py:67). Built from `torch.maximum` and `amax`, which split the
    gradient evenly over ties as jnp.maximum and jnp.max do (`relu` and
    `clamp` route it differently at 0)."""
    mse = torch.mean((pred - targets) ** 2)
    penalty = torch.amax(torch.maximum(-pred, torch.zeros_like(pred)))
    return mse + penalty


def dp_loss_terms(pred: torch.Tensor, targets: torch.Tensor,
                  dp: DataParallel):
    """`loss_terms` of the global batch from this rank's slice: (share,
    loss), the shares of the ranks summing to the loss. The MSE is a mean
    of equal slices; the penalty max(relu(-pred)) is the global max M,
    and its share is the sum of this rank's entries tied at M over the
    global count of ties (amax's even split of the gradient)."""
    mse = torch.mean((pred - targets) ** 2)
    pen = torch.maximum(-pred, torch.zeros_like(pred))
    top = pmax(pen.amax().detach(), dp.group)
    ties = pen.detach() == top
    n_ties = psum(ties.sum(), dp.group)
    share = mse / dp.world + (pen * ties).sum() / n_ties
    return share, dp.mean(mse) + top


def train(config: TrainDiffusionConfig = TrainDiffusionConfig(),
          dataset: Optional[StackedGraphs] = None, init_params=None, *,
          mesh=None, device="cuda"):
    """Returns (model holding the best parameters, history dict with
    train_loss, val_loss, epoch_time_s per epoch and test_loss).

    `init_params` warm-starts from a state dict, e.g. one carried from the
    JAX package by `checkpoints.diffusion_params_from_jax`; otherwise the
    model is drawn from a torch.Generator seeded with config.seed.

    `mesh` (a DeviceMesh with a "data" axis) or config.n_devices turns on
    data-parallel training as in `train_jacobi.train`
    (`training/data_parallel.py`). The loss's positivity penalty is a max
    over the global batch: each rank's share holds its entries tied at
    that max, each weighted by one over the global count of ties, which
    splits the gradient as `amax` does."""
    cfg = config
    dp = DataParallel.from_args(mesh, cfg.n_devices, cfg.batch_size)
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    if dataset is None:
        dataset = cosine_diffusion_dataset(cfg.num_matrices, n=cfg.n_mesh,
                                           max_freq=cfg.max_freq,
                                           seed=cfg.seed,
                                           convection=cfg.convection,
                                           cache_dir=cfg.cache_dir,
                                           device=device)
    n_all = dataset.n_graphs
    n_tr = int(n_all * cfg.split[0])
    n_va = int(n_all * cfg.split[1])
    perm = rng.permutation(n_all)
    tr = dataset.select(perm[:n_tr])
    va = dataset.select(perm[n_tr:n_tr + n_va])
    te = dataset.select(perm[n_tr + n_va:])

    rel = edge_features(dataset, cfg.n_mesh)
    model = DiffusionGNN(cfg.n_layers_external, cfg.n_layers_internal,
                         n_hidden=cfg.n_hidden, encoder=cfg.encoder,
                         decoder=cfg.decoder, generator=cfg.seed,
                         device=device)
    if init_params is not None:
        model.load_state_dict(init_params)
    if dp is not None:
        dp.sync_parameters(model)
    apply_batch, band_pack = make_apply_banded(
        model, dataset, rel, grid_shape=(cfg.n_mesh, cfg.n_mesh))

    def put(split: StackedGraphs):
        """The split's (ov bands, diags, globals, targets) as float32
        tensors on the device, moved once."""
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                     for a in (band_pack(split.offdiag_vals), split.diags,
                               split.globals_, split.targets))

    tr_t, va_t = put(tr), put(va)
    te_t = put(te) if te.n_graphs else None
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    plateau = PlateauScale(optimizer)

    def loss_fn(ov, d, g, y):
        return loss_terms(apply_batch(ov, d, g), y)

    step_fn = loss_fn
    if dp is not None:
        def step_fn(ov, d, g, y):
            return dp_loss_terms(apply_batch(*map(dp.split, (ov, d, g))),
                                 dp.split(y), dp)

    def eval_loss(tensors) -> float:
        """A whole split's loss, replicated on every rank (and averaged
        over them, so every rank's plateau steps alike)."""
        with torch.no_grad():
            loss = loss_fn(*tensors)
        return float(loss if dp is None else dp.mean(loss))

    history = {"train_loss": [], "val_loss": [], "epoch_time_s": []}
    lead = dp is None or dp.rank == 0  # the rank that logs and saves
    ckpt = (CheckpointManager(cfg.checkpoint_dir)
            if lead and cfg.checkpoint_dir else None)
    best_val, since_best = np.inf, 0
    best_state = {k: v.clone() for k, v in model.state_dict().items()}
    val_loss = np.inf

    for epoch in range(cfg.epochs):
        t0 = time.time()
        order = rng.permutation(tr.n_graphs)
        losses, sizes = [], []
        for start in range(0, tr.n_graphs, cfg.batch_size):
            idx = order[start:start + cfg.batch_size]
            if len(idx) < cfg.batch_size and sizes:
                break  # static batch shape: drop the ragged tail
            sel = torch.from_numpy(idx).to(device)
            batch = tuple(a.index_select(0, sel) for a in tr_t)
            losses.append(train_step(model, optimizer, plateau, step_fn,
                                     batch, val_loss, dp))
            sizes.append(len(idx))
        epoch_loss = sum(float(l) * s for l, s in zip(
            torch.stack(losses).tolist(), sizes))
        val_loss = eval_loss(va_t)
        history["train_loss"].append(epoch_loss / max(sum(sizes), 1))
        history["val_loss"].append(val_loss)
        history["epoch_time_s"].append(time.time() - t0)
        if lead and cfg.log_every and (epoch == 0
                                       or (epoch + 1) % cfg.log_every == 0):
            print(f"epoch {epoch + 1}: train {history['train_loss'][-1]:.5f} "
                  f"val {val_loss:.5f}")
        if ckpt:
            ckpt.save(epoch, model, metrics={"val_loss": val_loss})
        if val_loss < best_val - 1e-12:
            # the optimizer updates the parameters in place: keep a copy
            best_val, since_best = val_loss, 0
            best_state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            since_best += 1
            if since_best >= cfg.patience:
                if lead:
                    print(f"early stopping at epoch {epoch + 1}")
                break

    model.load_state_dict(best_state)
    history["test_loss"] = eval_loss(te_t) if te_t is not None else None
    if lead and te_t is not None:
        print(f"test loss: {history['test_loss']:.5f}")
    return model, history
