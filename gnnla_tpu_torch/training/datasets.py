"""Datasets of same-pattern matrices — the small-band part of
gnnla_tpu/training/datasets.py.

FEM matrices on a fixed mesh share one sparsity pattern, so a bucket is a
pattern template (a SparseOperator on the training device) plus stacked
host value arrays [B, E] / [B, N]; a batch is a slice of the stacks. One
compressed npz per bucket caches it, in the JAX package's file format and
under its file name, so either package reads the other's cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.problems.small_band import small_band_matrix_host


def _parallel_map(fn, args_list, min_parallel: int = 64):
    """Host-process fan-out for matrix generation. Workers are forked and
    run pure-numpy generators only. Serial for small jobs, single-core
    hosts, GNNLA_SERIAL_DATAGEN=1, or once this process has initialised
    CUDA: a forked child cannot use the parent's CUDA context."""
    n_workers = os.cpu_count() or 1
    if (len(args_list) < min_parallel or n_workers < 2
            or os.environ.get("GNNLA_SERIAL_DATAGEN")
            or torch.cuda.is_initialized()):
        return [fn(a) for a in args_list]
    import multiprocessing as mp
    with mp.get_context("fork").Pool(processes=min(n_workers, 8)) as pool:
        return pool.map(fn, args_list,
                        chunksize=max(1, len(args_list) // (4 * n_workers)))


def _gen_small_band(args):
    return small_band_matrix_host(*args)


@dataclasses.dataclass
class StackedGraphs:
    """A bucket of same-pattern graphs, stacked.

    template        : full-pattern SparseOperator (values of sample 0)
    template_nodiag : the diagonal-removed pattern
    vals            : [B, E_full] full-pattern values per sample
    offdiag_vals    : [B, E_nd]   off-diagonal values per sample
    diags           : [B, N]      diagonal per sample
    coords          : [B, N, 2]   vertex coordinates (None if n/a)
    meta            : per-sample scalars (h, band_loc)
    """

    template: SparseOperator
    template_nodiag: SparseOperator
    vals: np.ndarray
    offdiag_vals: np.ndarray
    diags: np.ndarray
    coords: Optional[np.ndarray] = None
    meta: Optional[Dict[str, np.ndarray]] = None

    @property
    def n_graphs(self) -> int:
        return self.vals.shape[0]

    def band_stack_nodiag(self):
        """(BandLayout, band_ov [B, K, N]): the off-diagonal values in the
        band layout (ops/band.py), packed on the host once — the input of
        the banded features."""
        from gnnla_tpu_torch.ops.band import BandLayout

        lay = BandLayout(self.template_nodiag)
        return lay, lay.pack(self.offdiag_vals)

    def dia_stack(self):
        """(offsets, diags [B, K, N] float64): the bucket in DIA form."""
        rows, cols, _ = self.template.host_coo()
        offs = cols - rows
        uniq = np.unique(offs)
        off_idx = np.searchsorted(uniq, offs)
        diags = np.zeros((self.n_graphs, uniq.size, self.template.n_rows))
        np.add.at(diags, (slice(None), off_idx, rows),
                  self.vals.astype(np.float64))
        return tuple(int(o) for o in uniq), diags

    def select(self, idx) -> "StackedGraphs":
        idx = np.asarray(idx)
        return dataclasses.replace(
            self, vals=self.vals[idx], offdiag_vals=self.offdiag_vals[idx],
            diags=self.diags[idx],
            coords=None if self.coords is None else self.coords[idx],
            meta=None if self.meta is None else
            {k: v[idx] for k, v in self.meta.items()})


def _stack_from_ops(ops, device="cuda"):
    """Split same-pattern host SparseOperators into (template on `device`,
    its diagonal-removed pattern, vals, offdiag_vals, diags)."""
    rows0, cols0, _ = ops[0].host_coo()
    for op in ops[1:]:
        r, c, _ = op.host_coo()
        if not (np.array_equal(r, rows0) and np.array_equal(c, cols0)):
            raise ValueError("bucketed samples must share one pattern")
    vals = np.stack([op.host_coo()[2] for op in ops])
    template = SparseOperator.from_coo(rows0, cols0, vals[0], ops[0].shape,
                                       coalesce=False, device=device)
    offdiag_vals = vals[:, rows0 != cols0]
    diags = np.stack([op.host_diagonal() for op in ops])
    return (template, template.remove_diagonal(), vals, offdiag_vals,
            diags)


def small_band_dataset(num_matrices: int, *, n: int = 38,
                       h_low: float = 0.0005, seed: int = 54681,
                       cache_dir: Optional[str] = None,
                       device="cuda") -> StackedGraphs:
    """Small-band FEM matrices at fixed resolution n (one pattern bucket),
    drawn as the reference's SmallBandDataset draws them
    (Data.py:148-163): h ~ U(h_low, 1/(2(n-2))), band_loc ~ U(0.05, 0.95),
    from numpy's default_rng(seed) in the JAX package's order."""
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"smallband_{num_matrices}_{n}_{h_low}_{seed}.npz")
        if os.path.exists(cache):
            return _load_stacked(cache, device)

    rng = np.random.default_rng(seed)
    args, hs = [], []
    for _ in range(num_matrices):
        h_high = 1.0 / (2 * (n - 2))
        h = (h_high - h_low) * rng.random() + h_low
        band_loc = 0.9 * rng.random() + 0.05
        args.append((n, h, band_loc))
        hs.append(h)
    results = _parallel_map(_gen_small_band, args)
    ops = [SparseOperator.from_scipy(K, device="cpu") for K, _, _ in results]
    template, nodiag, vals, offdiag_vals, diags = _stack_from_ops(ops,
                                                                  device)
    ds = StackedGraphs(
        template=template, template_nodiag=nodiag, vals=vals,
        offdiag_vals=offdiag_vals, diags=diags,
        coords=np.stack([xy for _, xy, _ in results]),
        meta={"h": np.asarray(hs),
              "band_loc": np.asarray([bl for _, _, bl in results])})
    if cache:
        _save_stacked(cache, ds)
    return ds


def _save_stacked(path: str, ds: StackedGraphs) -> None:
    rows, cols, _ = ds.template.host_coo()
    payload = dict(t_rows=rows, t_cols=cols,
                   t_shape=np.asarray(ds.template.shape), vals=ds.vals,
                   offdiag_vals=ds.offdiag_vals, diags=ds.diags)
    if ds.coords is not None:
        payload["coords"] = ds.coords
    for k, v in (ds.meta or {}).items():
        payload[f"meta_{k}"] = v
    np.savez_compressed(path, **payload)


def _load_stacked(path: str, device="cuda") -> StackedGraphs:
    z = np.load(path)
    shape = tuple(int(s) for s in z["t_shape"])
    template = SparseOperator.from_coo(z["t_rows"], z["t_cols"],
                                       z["vals"][0], shape, coalesce=False,
                                       device=device)
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return StackedGraphs(
        template=template, template_nodiag=template.remove_diagonal(),
        vals=z["vals"], offdiag_vals=z["offdiag_vals"], diags=z["diags"],
        coords=z["coords"] if "coords" in z.files else None,
        meta=meta or None)
