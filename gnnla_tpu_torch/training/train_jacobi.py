"""The trainable-Jacobi trainer — the counterpart of
gnnla_tpu/training/train_jacobi.py.

The reference's recipe (TrainableJacobiDiag/train.py:52-133): Adam at lr
1e-2 with a reduce-on-plateau scale, 62 epochs, batch 100, seed 54681, an
800/50/150 split of 1000 small-band matrices, and the mean Gelfand
damping factor at omega = 2/3 as the loss; afterwards a dense eigen
comparison against omega = 1, 2/3 and the optimal omega.

A batch is one pattern bucket: the vertex features run on the band layout
(`jacobi_diag_features_banded`) and the Gelfand applications on the DIA
layout (shifted slices) or the stencil layout (grid rolls), with the JAX
package's vmap over the batch written out as a leading batch dimension.
Neither layout reaches a kernel, in JAX as here.

numpy's generator is consumed in the JAX package's order (split
permutation, validation probes, then per epoch the batch order and each
batch's probes), so both packages train on the same draws. The optimizer
is torch's Adam (optax.adam's update, defaults b1 0.9, b2 0.999, eps 1e-8)
scaled by `PlateauScale`, optax's `contrib.reduce_on_plateau`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models.trainable_jacobi import (
    TrainableJacobiMLP, jacobi_diag_features, jacobi_diag_features_banded)
from gnnla_tpu_torch.ops.band import BandLayout
from gnnla_tpu_torch.ops.dia import DIAOperator
from gnnla_tpu_torch.ops.stencil import stencil_classes
from gnnla_tpu_torch.training import spectral_loss
from gnnla_tpu_torch.training.checkpoints import CheckpointManager
from gnnla_tpu_torch.training.data_parallel import DataParallel
from gnnla_tpu_torch.training.datasets import (StackedGraphs,
                                               host_eig_map,
                                               small_band_dataset)


@dataclasses.dataclass
class TrainJacobiConfig:
    num_matrices: int = 1000
    n_mesh: int = 38
    h_low: float = 0.0005
    epochs: int = 62
    batch_size: int = 100
    lr: float = 1e-2
    seed: int = 54681
    n_train: int = 800
    n_val: int = 50
    n_test: int = 150
    m_probes: int = 20
    gelfand_k: int = 3
    omega: float = 2.0 / 3.0
    widths: tuple = (50, 20, 1)
    init_scheme: str = "reference"
    # layout of the Gelfand applications: "dia" (shifted slices, any
    # banded pattern) or "stencil" (grid rolls, square-grid buckets);
    # identical numerics
    loss_layout: str = "dia"
    # stability penalty (an extension of the JAX package, not in the
    # reference): w * relu(gelfand(random probes, stability_k) - margin)^2
    stability_weight: float = 0.0
    stability_margin: float = 1.2
    stability_k: int = 10
    cache_dir: Optional[str] = "data_cache"
    checkpoint_dir: Optional[str] = None
    log_every: int = 1
    # data-parallel training over the ranks of an initialized process
    # group of this size (see `train`'s mesh)
    n_devices: Optional[int] = None


class PlateauScale:
    """optax.contrib.reduce_on_plateau at the JAX trainer's settings
    (factor 0.1, patience 10, rtol 1e-4, atol 0, cooldown 0, one value
    per update), scaling the updates of a torch optimizer: each
    `step(value)` runs optax's state machine on `value` (in float32, as
    optax does) and sets every group's lr to its initial lr times the
    scale, so the next `optimizer.step()` moves by the scaled update. Fed
    the previous epoch's validation loss at every training step (inf in
    the first epoch), as the JAX trainer feeds optax; it counts steps, not
    epochs, unlike torch.optim.lr_scheduler.ReduceLROnPlateau."""

    FACTOR = np.float32(0.1)
    PATIENCE = 10
    RTOL = 1e-4

    def __init__(self, optimizer: torch.optim.Optimizer):
        self.optimizer = optimizer
        self.initial_lrs = [g["lr"] for g in optimizer.param_groups]
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0

    def step(self, value: float) -> float:
        """Feed one value; returns the scale now applied."""
        value = np.float32(value)
        # optax's test: value < (1 - rtol) * best - atol, in float32
        if value < np.float32(1.0 - self.RTOL) * self.best_value:
            self.best_value = value
            self.plateau_count = 0
        else:
            self.plateau_count += 1
            if self.plateau_count == self.PATIENCE:
                self.plateau_count = 0
                self.scale = self.scale * self.FACTOR
        for group, lr in zip(self.optimizer.param_groups, self.initial_lrs):
            group["lr"] = lr * float(self.scale)
        return float(self.scale)


def feature_stack(ds: StackedGraphs) -> np.ndarray:
    """The off-diagonal band stack [B, K, N]: `make_loss_fn`'s loss's
    second argument (the banded feature path, ops/band.py)."""
    return ds.band_stack_nodiag()[1]


def _stencil_meta(ds: StackedGraphs):
    """(shifts, h, w) of a grid bucket's shared pattern. The grid shape
    comes from the vertex coordinates when they form a row-major tensor
    grid, else from sqrt(n); a non-grid bucket raises (here, or in
    `stencil_classes`' class bound)."""
    n = ds.template.n_rows
    h = w = None
    if ds.coords is not None:
        xy = np.asarray(ds.coords[0])
        ux, uy = np.unique(xy[:, 0]), np.unique(xy[:, 1])
        if len(ux) * len(uy) == n:
            ix = np.searchsorted(ux, xy[:, 0])
            iy = np.searchsorted(uy, xy[:, 1])
            if np.array_equal(iy * len(ux) + ix, np.arange(n)):
                h, w = len(uy), len(ux)
    if h is None:
        h = w = math.isqrt(n)
        if h * h != n:
            raise ValueError(
                f"loss_layout='stencil' needs a tensor-product grid "
                f"bucket; could not infer a grid shape for n_rows={n}")
    rows, cols, _ = ds.template.host_coo()
    shifts, _ = stencil_classes(rows, cols, h, w)
    return shifts, h, w


def matrix_stack(ds: StackedGraphs, layout: str) -> np.ndarray:
    """Host stacked matrix data, the first argument of `make_loss_fn`'s
    loss: DIA diagonals [B, K, N] or stencil planes [B, K, H, W]."""
    if layout == "dia":
        return ds.dia_stack()[1]
    shifts, h, w = _stencil_meta(ds)
    rows, cols, _ = ds.template.host_coo()
    _, k_idx = stencil_classes(rows, cols, h, w)
    b = ds.vals.shape[0]
    planes = np.zeros((b, len(shifts) * h * w), np.float32)
    flat = (k_idx * (h * w) + rows).astype(np.int64)
    np.add.at(planes, (np.arange(b)[:, None], flat[None, :]), ds.vals)
    return planes.reshape(b, len(shifts), h, w)


def make_loss_fn(model: TrainableJacobiMLP, ds: StackedGraphs, omega: float,
                 k: int, layout: str = "dia", stability_weight: float = 0.0,
                 stability_margin: float = 1.2, stability_k: int = 10):
    """The batched loss of `model` on the bucket's pattern:

        loss_fn(mats, band_ov, diags, probes, probes_full=None) -> scalar

    mats from `matrix_stack(ds, layout)` [B, K, N] or [B, K, H, W],
    band_ov from `feature_stack(ds)` [B, K', N], diags [B, N], probes
    [B, N, m] (and probes_full [B, N, m] for the stability penalty), all
    float32 on the model's device. The mean Gelfand damping factor of the
    learned diagonals, plus the penalty where stability_weight > 0."""
    device = next(model.parameters()).device
    n = ds.template.n_rows
    blay = BandLayout(ds.template_nodiag)
    f_mask = torch.from_numpy(blay.mask).to(device)
    f_deg = torch.from_numpy(np.maximum(blay.deg, 1).astype(np.float32)).to(
        device)

    if layout == "dia":
        rows, cols, _ = ds.template.host_coo()
        offsets = tuple(int(o) for o in np.unique(cols - rows))
        nnz = ds.template.nnz

        def gelfand(mats, dvals, probes, kk):
            op = DIAOperator(mats, offsets, n, nnz)
            return spectral_loss.damping_factor_gelfand(op, dvals, omega,
                                                        probes, k=kk)
    elif layout == "stencil":
        shifts, h, w = _stencil_meta(ds)

        def gelfand(mats, dvals, probes, kk):
            b = dvals.shape[0]
            return spectral_loss.damping_factor_gelfand_stencil(
                mats, shifts, dvals.reshape(b, h, w), omega,
                probes.reshape(b, h, w, -1), k=kk)
    else:
        raise ValueError(f"unknown loss layout {layout!r}; "
                         "expected 'dia' or 'stencil'")

    def loss_fn(mats, band_ov, diags, probes, probes_full=None):
        feats = jacobi_diag_features_banded(diags, band_ov, f_mask, f_deg)
        dvals = model(feats).reshape(diags.shape)
        loss = torch.mean(gelfand(mats, dvals, probes, k))
        if probes_full is not None and stability_weight:
            # the full-spectrum Gelfand factor at the deeper stability_k:
            # above the margin, the sweep amplifies somewhere
            gfull = gelfand(mats, dvals, probes_full, stability_k)
            loss = loss + stability_weight * torch.mean(
                torch.relu(gfull - stability_margin) ** 2)
        return loss

    return loss_fn


def _draw_probes(ds: StackedGraphs, idx, m: int, rng) -> np.ndarray:
    n_v = ds.template.n_rows
    return np.stack([
        spectral_loss.high_freq_probes(
            n_v, m, ds.coords[i] if ds.coords is not None else None, rng)
        for i in idx])


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               plateau: PlateauScale, loss_fn, batch,
               plateau_value: float, dp: Optional[DataParallel] = None
               ) -> torch.Tensor:
    """One step: the loss and its gradient, the plateau scale fed
    `plateau_value`, the scaled Adam update. Returns the loss (detached,
    on the device).

    Data-parallel (`dp`): loss_fn returns (share, loss) on this rank's
    slice of the batch, where the shares of the ranks sum to the global
    batch's loss; their gradients are summed over the ranks, and the
    global loss is returned."""
    optimizer.zero_grad(set_to_none=True)
    if dp is None:
        loss = loss_fn(*batch)
        loss.backward()
    else:
        share, loss = loss_fn(*batch)
        share.backward()
        dp.sum_gradients(model)
    plateau.step(plateau_value)
    optimizer.step()
    return loss.detach()


def train(config: TrainJacobiConfig = TrainJacobiConfig(),
          dataset: Optional[StackedGraphs] = None, init_params=None, *,
          mesh=None, device="cuda"):
    """Returns (model, history dict with train_loss, val_loss,
    epoch_time_s per epoch and test_loss).

    `init_params` warm-starts from a state dict, e.g. one carried from
    the JAX package by `checkpoints.params_from_jax`;
    otherwise the MLP is drawn from a torch.Generator seeded with
    config.seed.

    `mesh` (a DeviceMesh with a "data" axis, or config.n_devices, the
    size of the initialized process group) turns on data-parallel
    training (`training/data_parallel.py`): each rank takes its equal
    slice of every training batch, the gradients are summed over the
    ranks into the global batch's, rank 0's initial parameters are
    broadcast, and validation and test batches stay whole on every
    rank. batch_size must divide the axis (ValueError)."""
    cfg = config
    dp = DataParallel.from_args(mesh, cfg.n_devices, cfg.batch_size)
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    if dataset is None:
        dataset = small_band_dataset(cfg.num_matrices, n=cfg.n_mesh,
                                     h_low=cfg.h_low, seed=cfg.seed,
                                     cache_dir=cfg.cache_dir, device=device)

    perm = rng.permutation(dataset.n_graphs)
    tr = dataset.select(perm[:cfg.n_train])
    va = dataset.select(perm[cfg.n_train:cfg.n_train + cfg.n_val])
    te = dataset.select(perm[cfg.n_train + cfg.n_val:
                             cfg.n_train + cfg.n_val + cfg.n_test])

    model = TrainableJacobiMLP(cfg.widths, cfg.init_scheme,
                               generator=cfg.seed, device=device)
    if init_params is not None:
        model.load_state_dict(init_params)
    if dp is not None:
        dp.sync_parameters(model)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    plateau = PlateauScale(optimizer)
    loss_fn = make_loss_fn(model, dataset, cfg.omega, cfg.gelfand_k,
                           layout=cfg.loss_layout,
                           stability_weight=cfg.stability_weight,
                           stability_margin=cfg.stability_margin,
                           stability_k=cfg.stability_k)
    stab = cfg.stability_weight > 0
    step_fn = loss_fn
    if dp is not None:
        def step_fn(*batch):
            # each term is a mean over the batch: the slices' means
            # average to the global one
            local = loss_fn(*(dp.split(a) for a in batch))
            return local / dp.world, dp.mean(local)

    def stacks(ds):
        return (matrix_stack(ds, cfg.loss_layout).astype(np.float32),
                feature_stack(ds).astype(np.float32),
                ds.diags.astype(np.float32))

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    tr_stack, va_stack, te_stack = stacks(tr), stacks(va), stacks(te)
    history = {"train_loss": [], "val_loss": [], "epoch_time_s": []}
    lead = dp is None or dp.rank == 0  # the rank that logs and saves

    def whole_loss(stack, probes) -> float:
        """The loss of a whole split, replicated on every rank (and
        averaged over them, so every rank's plateau steps alike)."""
        with torch.no_grad():
            loss = loss_fn(*map(put, stack), put(probes))
        return float(loss if dp is None else dp.mean(loss))

    ckpt = (CheckpointManager(cfg.checkpoint_dir)
            if lead and cfg.checkpoint_dir else None)

    val_probes = _draw_probes(va, range(va.n_graphs), cfg.m_probes, rng)
    val_loss = np.inf

    for epoch in range(cfg.epochs):
        t0 = time.time()
        order = rng.permutation(tr.n_graphs)
        epoch_loss, n_seen = 0.0, 0
        for start in range(0, tr.n_graphs, cfg.batch_size):
            idx = order[start:start + cfg.batch_size]
            if len(idx) < cfg.batch_size:
                break  # static batch shape: drop the ragged tail
            probes = _draw_probes(tr, idx, cfg.m_probes, rng)
            batch = tuple(put(a[idx]) for a in tr_stack) + (put(probes),)
            if stab:
                batch += (put(rng.standard_normal(
                    (len(idx), dataset.template.n_rows, cfg.m_probes))),)
            loss = train_step(model, optimizer, plateau, step_fn, batch,
                              val_loss, dp)
            epoch_loss += float(loss) * len(idx)
            n_seen += len(idx)

        val_loss = whole_loss(va_stack, val_probes)
        dt = time.time() - t0
        history["train_loss"].append(epoch_loss / max(n_seen, 1))
        history["val_loss"].append(val_loss)
        history["epoch_time_s"].append(dt)
        if lead and cfg.log_every and (epoch == 0
                                       or (epoch + 1) % cfg.log_every == 0):
            print(f"epoch {epoch + 1}: train {history['train_loss'][-1]:.5f} "
                  f"val {val_loss:.5f} ({dt:.1f}s)")
        if ckpt:
            ckpt.save(epoch, model, metrics={"val_loss": val_loss})

    te_probes = _draw_probes(te, range(te.n_graphs), cfg.m_probes, rng)
    history["test_loss"] = whole_loss(te_stack, te_probes)
    if lead:
        print(f"test loss: {history['test_loss']:.5f}")
    return model, history


def _baseline_row(job) -> tuple:
    """(learned, w1, w23, opt) damping factors of one matrix, host
    float64: job = (rows, cols, vals, n, diag, d_learn)."""
    rows, cols, vals, n, diag, d_learn = job
    A = np.zeros((n, n), np.float32)
    A[rows, cols] = vals
    # one spectrum of D^-1 A serves omega = 1, 2/3 and the optimum
    lam = spectral_loss.dinv_a_spectrum(A, diag)
    w_opt = 2.0 / (np.max(np.abs(lam)) + np.min(np.abs(lam)))
    return (spectral_loss.damping_factor_exact(A, d_learn, 2.0 / 3.0),
            float(np.max(np.abs(1.0 - lam))),
            float(np.max(np.abs(1.0 - (2.0 / 3.0) * lam))),
            float(np.max(np.abs(1.0 - w_opt * lam))))


def evaluate_vs_baselines(params, dataset: StackedGraphs,
                          cfg: TrainJacobiConfig,
                          max_graphs: Optional[int] = None) -> dict:
    """Exact mean damping factors of the learned D (at omega = 2/3) and of
    omega = 1, 2/3 and the per-matrix optimal omega with D = diag(A), by
    dense eigenvalues on the host, over the whole split by default (the
    reference's train.py:164-213). `params`: the MLP's state dict. The
    eigenproblems of many matrices run on a host pool
    (`datasets.host_eig_map`)."""
    dev = dataset.template.device
    model = TrainableJacobiMLP(cfg.widths, cfg.init_scheme, device=dev)
    model.load_state_dict(params)
    n_graphs = dataset.n_graphs if max_graphs is None else min(
        dataset.n_graphs, max_graphs)
    rows, cols, _ = dataset.template.host_coo()
    jobs = []
    for i in range(n_graphs):
        diag = dataset.diags[i].astype(np.float32)
        feats = jacobi_diag_features(
            dataset.template_nodiag.with_values(
                dataset.offdiag_vals[i].astype(np.float32)),
            torch.from_numpy(diag).to(dev))
        with torch.no_grad():
            dlearn = model(feats).reshape(-1).cpu().numpy()
        jobs.append((rows, cols, dataset.vals[i].astype(np.float32),
                     dataset.template.n_rows, diag, dlearn))
    per_graph = np.asarray(host_eig_map(_baseline_row, jobs))
    return {k: float(np.mean(per_graph[:, j]))
            for j, k in enumerate(("learned", "w1", "w23", "opt"))}
