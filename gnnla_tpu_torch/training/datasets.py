"""Datasets of same-pattern matrices — the counterpart of
gnnla_tpu/training/datasets.py: the small-band and stretched-mesh families
of the learned Jacobi smoother, and the cosine, constant and
frequency-study diffusion families of the diffusion-coefficient model.

FEM matrices on a fixed mesh share one sparsity pattern, so a bucket is a
pattern template (a SparseOperator on the training device) plus stacked
host value arrays [B, E] / [B, N]; a batch is a slice of the stacks. One
compressed npz per bucket caches it, in the JAX package's file format and
under its file name, so either package reads the other's cache. The draws
are the JAX package's: the same numpy generator consumed in the same order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.problems.diffusion_fem import (alpha_beta_targets,
                                                    assemble_periodic,
                                                    constant_diffusion_matrix,
                                                    cosine_field,
                                                    element_stiffness_field)
from gnnla_tpu_torch.problems.fem_heateqn import heateqn_fem_2d_host
from gnnla_tpu_torch.problems.small_band import small_band_matrix_host


def pool_kind(n_jobs: int, min_parallel: int = 64) -> str:
    """How `_parallel_map` runs n_jobs generators: "serial" for small jobs,
    single-core hosts or GNNLA_SERIAL_DATAGEN=1; "spawn" once this process
    has initialised CUDA (a forked child cannot use the parent's CUDA
    context, and fresh workers need none: the generators are pure numpy);
    "fork" otherwise."""
    if (n_jobs < min_parallel or (os.cpu_count() or 1) < 2
            or os.environ.get("GNNLA_SERIAL_DATAGEN")):
        return "serial"
    return "spawn" if torch.cuda.is_initialized() else "fork"


def _parallel_map(fn, args_list, min_parallel: int = 64):
    """[fn(a) for a in args_list] on the host process pool `pool_kind`
    names. `fn` is a module-level pure-numpy generator, so the results are
    the same whatever the pool."""
    kind = pool_kind(len(args_list), min_parallel)
    if kind == "serial":
        return [fn(a) for a in args_list]
    import multiprocessing as mp
    n_workers = min(os.cpu_count() or 1, 8, len(args_list))
    with mp.get_context(kind).Pool(processes=n_workers) as pool:
        return pool.map(fn, args_list,
                        chunksize=max(1, len(args_list) // (4 * n_workers)))


# the dense eigenproblems of the evaluation tools: fewer than this many
# run in the calling process
EIG_POOL_MIN_JOBS = 16
_BLAS_THREAD_VARS = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                     "MKL_NUM_THREADS")


def host_eig_map(fn, jobs):
    """[fn(j) for j in jobs] for dense host eigenproblems: in this process
    for few jobs, on one core or with GNNLA_SERIAL_DATAGEN=1; else on
    spawned workers, one a core, each with a one-thread BLAS. A threaded
    BLAS in every worker oversubscribes the cores many times over (16
    eigensolves of 1045^2 on 8 cores: 3.3 s with one thread a worker, 206
    s with eight); spawned workers read the thread count as they load
    their BLAS. `fn` is a module-level numpy function of its job."""
    n_workers = min(os.cpu_count() or 1, len(jobs))
    if (len(jobs) < EIG_POOL_MIN_JOBS or n_workers < 2
            or os.environ.get("GNNLA_SERIAL_DATAGEN")):
        return [fn(j) for j in jobs]
    import multiprocessing as mp
    saved = {k: os.environ.get(k) for k in _BLAS_THREAD_VARS}
    os.environ.update({k: "1" for k in _BLAS_THREAD_VARS})
    try:
        with mp.get_context("spawn").Pool(processes=n_workers) as pool:
            return pool.map(fn, jobs, chunksize=1)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _gen_small_band(args):
    return small_band_matrix_host(*args)


def _gen_cosine(args):
    thetas, n, convection, ref_sym = args
    tax, tay, tbx, tby = thetas
    ke = element_stiffness_field(n, cosine_field(tax, tay),
                                 cosine_field(tbx, tby),
                                 convection=convection,
                                 reference_symmetrized=ref_sym)
    return assemble_periodic(ke, n)


def _gen_stretched(args):
    n_cells, stretch = args
    return heateqn_fem_2d_host((n_cells, n_cells), (1.0, stretch), (2, 2))


@dataclasses.dataclass
class StackedGraphs:
    """A bucket of same-pattern graphs, stacked.

    template        : full-pattern SparseOperator (values of sample 0)
    template_nodiag : the diagonal-removed pattern
    vals            : [B, E_full] full-pattern values per sample
    offdiag_vals    : [B, E_nd]   off-diagonal values per sample
    diags           : [B, N]      diagonal per sample
    coords          : [B, N, 2]   vertex coordinates (None if n/a)
    targets         : [B, N, T]   regression targets (None if n/a)
    globals_        : [B, G]      per-graph globals (None if n/a)
    meta            : per-sample scalars (h, band_loc, thetas, ...)
    """

    template: SparseOperator
    template_nodiag: SparseOperator
    vals: np.ndarray
    offdiag_vals: np.ndarray
    diags: np.ndarray
    coords: Optional[np.ndarray] = None
    targets: Optional[np.ndarray] = None
    globals_: Optional[np.ndarray] = None
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
            targets=None if self.targets is None else self.targets[idx],
            globals_=None if self.globals_ is None else self.globals_[idx],
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


def stretched_mesh_dataset(num_matrices: int, *, n_cells: int = 5,
                           max_stretch: float = 5.0, seed: int = 0,
                           cache_dir: Optional[str] = None,
                           device="cuda") -> StackedGraphs:
    """Stretched-mesh heat-equation matrices (one pattern bucket): the
    reference's MATLAB training set, heateqnfem2dfun([5,5],[1,stretch],
    [2,2]) with stretch swept linearly over [1, max_stretch]
    (train_jacobi_find_d.m:59-82). A nonzero `seed` jitters each stretch
    uniformly within its slot."""
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir,
            f"stretched_{num_matrices}_{n_cells}_{max_stretch}_{seed}.npz")
        if os.path.exists(cache):
            return _load_stacked(cache, device)

    rng = np.random.default_rng(seed)
    stretches = []
    # eliminated Dirichlet BCs keep the interior (n_cells-1)^2 vertices
    xs_int = np.linspace(0.0, 1.0, n_cells + 1)[1:-1]
    for i in range(num_matrices):
        frac = i / max(num_matrices - 1, 1)
        stretch = 1.0 + frac * (max_stretch - 1.0)
        if seed:
            slot = (max_stretch - 1.0) / max(num_matrices - 1, 1)
            stretch = min(max(1.0, stretch + slot * (rng.random() - 0.5)),
                          max_stretch)
        stretches.append(stretch)
    hosts = _parallel_map(_gen_stretched,
                          [(n_cells, st) for st in stretches])
    ops = [SparseOperator.from_scipy(K, device="cpu") for K in hosts]
    xy = np.stack(np.meshgrid(xs_int, xs_int, indexing="xy"),
                  axis=-1).reshape(-1, 2)
    if xy.shape[0] != ops[0].n_rows:
        raise ValueError(f"{xy.shape[0]} coordinates for "
                         f"{ops[0].n_rows} rows")
    template, nodiag, vals, offdiag_vals, diags = _stack_from_ops(ops,
                                                                  device)
    ds = StackedGraphs(template=template, template_nodiag=nodiag,
                       vals=vals, offdiag_vals=offdiag_vals, diags=diags,
                       coords=np.stack([xy] * num_matrices),
                       meta={"stretch": np.asarray(stretches)})
    if cache:
        _save_stacked(cache, ds)
    return ds


def _half_integer_freqs(max_freq: float):
    return [0.5 * i for i in range(int(2 * max_freq) + 1)
            if 0.5 * i <= max_freq]


def cosine_diffusion_dataset(num_matrices: int, *, n: int = 32,
                             max_freq: float = 3.0, seed: int = 41,
                             convection=None,
                             reference_symmetrized: bool = False,
                             cache_dir: Optional[str] = None,
                             device="cuda") -> StackedGraphs:
    """Cosine-diffusion FEM matrices at fixed resolution n, drawn as the
    reference's RandomCosineDiffusionDataset (data.py:137-221): thetas
    from {0, 0.5, ..., max_freq}; targets [alpha_i, beta_i]; global h.
    `convection=(cx, cy)` adds the advection term (the reference uses
    (0.1, 0)), assembled unsymmetrized unless `reference_symmetrized`."""
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        ckey = "" if convection is None else \
            f"_c{convection[0]}_{convection[1]}"
        if reference_symmetrized:
            ckey += "_refsym"
        cache = os.path.join(
            cache_dir,
            f"cosdiff_{num_matrices}_{n}_{max_freq}_{seed}{ckey}.npz")
        if os.path.exists(cache):
            return _load_stacked(cache, device)

    rng = np.random.default_rng(seed)
    freqs = _half_integer_freqs(max_freq)
    targets, thetas_all = [], []
    for _ in range(num_matrices):
        thetas = rng.choice(freqs, 4, replace=True)
        a, b = alpha_beta_targets(tuple(thetas), n)
        targets.append(np.stack([a, b], axis=1))
        thetas_all.append(thetas)
    hosts = _parallel_map(
        _gen_cosine, [(tuple(t), n, convection, reference_symmetrized)
                      for t in thetas_all])
    ops = [SparseOperator.from_scipy(K, device="cpu") for K in hosts]
    template, nodiag, vals, offdiag_vals, diags = _stack_from_ops(ops,
                                                                  device)
    ds = StackedGraphs(
        template=template, template_nodiag=nodiag, vals=vals,
        offdiag_vals=offdiag_vals, diags=diags, targets=np.stack(targets),
        globals_=np.full((num_matrices, 1), 1.0 / n),
        meta={"thetas": np.stack(thetas_all)})
    if cache:
        _save_stacked(cache, ds)
    return ds


def constant_diffusion_dataset(num_matrices: int, *, n: int = 32,
                               mode: str = "random", seed: int = 41,
                               cache_dir: Optional[str] = None,
                               device="cuda") -> StackedGraphs:
    """Constant-coefficient diffusion matrices at fixed resolution n.
    mode="random": alpha, beta ~ U(0, 1) (the reference's
    RandomConstantDiffusionDataset); mode="small_alpha_large_beta":
    alpha = 10^-i, beta = 0.8 (ConstantDiffusionDataset, the
    out-of-distribution sweep). Targets the constant [alpha_i, beta_i];
    global h."""
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"constdiff_{num_matrices}_{n}_{mode}_{seed}.npz")
        if os.path.exists(cache):
            return _load_stacked(cache, device)

    rng = np.random.default_rng(seed)
    ops, targets, alphas, betas = [], [], [], []
    for i in range(num_matrices):
        if mode == "random":
            alpha, beta = float(rng.random()), float(rng.random())
        elif mode == "small_alpha_large_beta":
            alpha, beta = 10.0 ** (-i), 0.8
        else:
            raise ValueError(f"unknown mode {mode!r}")
        ops.append(constant_diffusion_matrix(alpha, beta, n, device="cpu"))
        targets.append(np.stack([np.full(n * n, alpha),
                                 np.full(n * n, beta)], axis=1))
        alphas.append(alpha)
        betas.append(beta)
    template, nodiag, vals, offdiag_vals, diags = _stack_from_ops(ops,
                                                                  device)
    ds = StackedGraphs(
        template=template, template_nodiag=nodiag, vals=vals,
        offdiag_vals=offdiag_vals, diags=diags, targets=np.stack(targets),
        globals_=np.full((num_matrices, 1), 1.0 / n),
        meta={"alpha": np.asarray(alphas), "beta": np.asarray(betas)})
    if cache:
        _save_stacked(cache, ds)
    return ds


def frequency_study_dataset(*, n: int = 32, max_freq: float = 4.0,
                            cache_dir: Optional[str] = None,
                            device="cuda") -> StackedGraphs:
    """One cosine-diffusion matrix per (theta_x, theta_y) pair of the
    half-integer frequency grid, thetas = [tx, ty, tx, ty], ty the outer
    loop (the reference's FrequencyStudyDiffusionDataset,
    data.py:326-366)."""
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(cache_dir, f"freqstudy_{n}_{max_freq}.npz")
        if os.path.exists(cache):
            return _load_stacked(cache, device)

    freqs = _half_integer_freqs(max_freq)
    thetas_all = [(tx, ty, tx, ty) for ty in freqs for tx in freqs]
    hosts = _parallel_map(_gen_cosine,
                          [(t, n, None, False) for t in thetas_all])
    ops = [SparseOperator.from_scipy(K, device="cpu") for K in hosts]
    targets = [np.stack(alpha_beta_targets(t, n), axis=1)
               for t in thetas_all]
    template, nodiag, vals, offdiag_vals, diags = _stack_from_ops(ops,
                                                                  device)
    ds = StackedGraphs(
        template=template, template_nodiag=nodiag, vals=vals,
        offdiag_vals=offdiag_vals, diags=diags, targets=np.stack(targets),
        globals_=np.full((len(ops), 1), 1.0 / n),
        meta={"thetas": np.asarray(thetas_all)})
    if cache:
        _save_stacked(cache, ds)
    return ds


_PROBLEM_TYPES = ("cosine", "cosine_convection", "constant",
                  "small_alpha_large_beta", "freq_study")


def diffusion_data_module(problem_type: str = "cosine", *,
                          num_matrices: int = 1000, n: int = 32,
                          max_freq: float = 3.0, seed: int = 41,
                          split=(0.7, 0.2, 0.1),
                          cache_dir: Optional[str] = None, device="cuda"):
    """Dataset factory and its 70/20/10 split in order — the reference's
    DiffusionDataModule (data.py:371-455). Returns (train, val, test)
    views over one pattern bucket."""
    if problem_type not in _PROBLEM_TYPES:
        raise ValueError(
            f"unknown problem_type {problem_type!r}; expected one of "
            f"{sorted(_PROBLEM_TYPES)}")
    if problem_type in ("cosine", "cosine_convection"):
        conv = (0.1, 0.0) if problem_type == "cosine_convection" else None
        ds = cosine_diffusion_dataset(num_matrices, n=n, max_freq=max_freq,
                                      seed=seed, convection=conv,
                                      cache_dir=cache_dir, device=device)
    elif problem_type == "freq_study":
        ds = frequency_study_dataset(n=n, max_freq=max_freq,
                                     cache_dir=cache_dir, device=device)
    else:
        mode = "random" if problem_type == "constant" else problem_type
        ds = constant_diffusion_dataset(num_matrices, n=n, mode=mode,
                                        seed=seed, cache_dir=cache_dir,
                                        device=device)
    num = ds.n_graphs
    n_tr = int(split[0] * num)
    n_va = int(split[1] * num)
    idx = np.arange(num)
    return (ds.select(idx[:n_tr]), ds.select(idx[n_tr:n_tr + n_va]),
            ds.select(idx[n_tr + n_va:]))


def periodic_rel_coords(op_nodiag: SparseOperator, n: int) -> np.ndarray:
    """[E, 2] relative coordinates (col - row) on the n x n periodic grid,
    entries of magnitude n - 1 wrapped to -/+1 (reference
    data.py:108-119)."""
    rows, cols, _ = op_nodiag.host_coo()

    def rowcol(i):
        return np.stack([i % n, i // n], axis=1)

    rel = rowcol(cols) - rowcol(rows)
    rel = np.where(rel == n - 1, -1, rel)
    rel = np.where(rel == -(n - 1), 1, rel)
    return rel.astype(np.float64)


def _save_stacked(path: str, ds: StackedGraphs) -> None:
    rows, cols, _ = ds.template.host_coo()
    payload = dict(t_rows=rows, t_cols=cols,
                   t_shape=np.asarray(ds.template.shape), vals=ds.vals,
                   offdiag_vals=ds.offdiag_vals, diags=ds.diags)
    if ds.coords is not None:
        payload["coords"] = ds.coords
    if ds.targets is not None:
        payload["targets"] = ds.targets
    if ds.globals_ is not None:
        payload["globals"] = ds.globals_
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
        targets=z["targets"] if "targets" in z.files else None,
        globals_=z["globals"] if "globals" in z.files else None,
        meta=meta or None)
