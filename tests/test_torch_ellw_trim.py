"""K6's slot extents and K8's lane slabs on the CPU.

K6 reads, for each tile, only the slots up to the tile's last real one
and then adds the one term 0 * x[slot 0's column]; K8
gathers each 32-lane group from a slab of win's columns. The kernels run
only on the card, so their arithmetic is held here through plain PyTorch
twins: bitwise the wrappers' plain versions (K6 also on x with inf and
NaN) and, for K6, within 1e-5 * max|y| of the JAX script's kernel in
interpret mode (XLA on the CPU may contract its multiply-adds). Inputs
are made with numpy from fixed seeds.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnnla_tpu_torch.ops import ellw_spmv as E
from gnnla_tpu_torch.ops.gather_probe import (GATHER_SLAB_BYTES, SLAB_LANES,
                                              GatherProbe, axis0_path,
                                              axis0_plain)
from gnnla_tpu_torch.scratch import probe_dyngather, probe_stream, proto_ellw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def delaunay(n, seed=7):
    return proto_ellw.rcm_ordered(proto_ellw.delaunay_laplacian(
        n, np.random.default_rng(seed)))


def trim_twin(op: E.EllwSpMV, x: torch.Tensor) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch: each row sums its tile's slots
    0..T-1 in order, then, where T < K, adds 0 * x[slot 0's column]."""
    n_tiles, K = op.n_tiles, op.K
    x_pad = x.new_zeros(max(n_tiles * E.TILE + op.W, x.shape[0]))
    x_pad[:x.shape[0]] = x
    cols = op.start.long()[:, None, None] + op.idx.long().reshape(
        n_tiles, K, E.TILE)
    xs = x_pad[cols]
    prods = op.val.reshape(n_tiles, K, E.TILE) * xs
    T = op.seg[:, 0].long()[:, None]
    acc = torch.zeros((n_tiles, E.TILE), dtype=x.dtype)
    for k in range(K):
        acc = torch.where(k < T, acc + prods[:, k], acc)
    acc = torch.where(T < K, acc + 0.0 * xs[:, 0], acc)
    return acc.reshape(-1)[:op.n]


def slab_twin(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K8's lane-slab gather in plain PyTorch: lane group c reads the slab
    win[:, 32c:32c+32], flattened, at idx * 32 + lane."""
    out = torch.empty(idx.shape, dtype=win.dtype)
    lane = torch.arange(SLAB_LANES)
    for c in range(win.shape[1] // SLAB_LANES):
        cs = slice(SLAB_LANES * c, SLAB_LANES * (c + 1))
        slab = win[:, cs].contiguous().reshape(-1)
        out[..., cs] = slab[idx[..., cs].long() * SLAB_LANES + lane]
    return out


# ------------------------------------------------------- K6's extents
@pytest.mark.parametrize("n", [700, 3000, 16384])
def test_extent_is_each_tiles_longest_row(n):
    """On the RCM Delaunay Laplacians (every stored value nonzero) T is
    the longest row of the tile; [lo, hi) holds every column the tile
    reads, in multiples of 4 within the window."""
    lap = delaunay(n)
    meta = E.build_ellw(lap)
    seg = E.slot_extents(meta["idx"], meta["val"])
    deg = np.zeros(meta["L"], np.int64)
    deg[:n] = np.diff(lap.indptr)
    assert seg.dtype == np.int32 and seg.shape == (meta["n_tiles"], 4)
    np.testing.assert_array_equal(
        seg[:, 0], deg.reshape(-1, E.TILE).max(axis=1))
    assert seg[:, 0].max() == meta["K"] and (seg[:, 3] == 0).all()
    i = meta["idx"].reshape(meta["n_tiles"], -1)
    lo, hi = seg[:, 1], seg[:, 2]
    assert (lo % 4 == 0).all() and (hi % 4 == 0).all()
    assert (lo <= i.min(axis=1)).all() and (i.max(axis=1) < hi).all()
    assert (lo >= 0).all() and (hi <= meta["W"]).all()
    assert (lo > i.min(axis=1) - 4).all() and (hi <= i.max(axis=1) + 4).all()


def test_extent_on_the_delaunay_fixture_cuts_the_slots_read():
    """At 16,384 points most tiles end before K: the wrapper reads fewer
    slots than the layout stores, and its extents are slot_extents'."""
    op = E.EllwSpMV(E.build_ellw(delaunay(16384)), device=CPU)
    np.testing.assert_array_equal(
        op.seg.numpy(), E.slot_extents(op.idx.numpy(), op.val.numpy()))
    assert op.slots_read == int(op.seg[:, 0].sum()) < op.n_tiles * op.K
    assert 1.0 < op.read_waste < op.padding_waste


def test_extent_is_k_on_from_slots_layouts():
    """from_slots layouts (the stream probe's: every row K real slots)
    have no padding to skip."""
    cols, vals, _, _ = probe_stream.fixture()
    meta = E.from_slots(cols, vals)
    seg = E.slot_extents(meta["idx"], meta["val"])
    assert (seg[:, 0] == meta["K"]).all()


@pytest.mark.parametrize("last_col,last_val,want_T", [
    (700, 0.0, 4),    # an explicit zero on another column: not padding
    (700, 1.0, 4),
    (3, 0.0, 3),      # +0 on slot 0's column: padding, trimmed
    (3, -0.0, 4),     # -0 is not +0: kept
])
def test_extent_stops_at_an_explicit_zero_elsewhere(last_col, last_val,
                                                    want_T):
    """Only slots of value bits +0.0 on the row's slot-0 column count as
    padding. Row 0 of a 1024-row tile holds columns 3, 5, 9, `last_col`
    (values 2, 1, 1, `last_val`); every other row its own column alone.
    The CSR keeps an explicit zero; the slots (`from_slots`) also keep a
    second entry on column 3, which a CSR would sum."""
    if last_col == 3:
        cols = np.zeros((1024, 4), np.int64)
        vals = np.zeros((1024, 4), np.float32)
        cols[0], vals[0] = [3, 5, 9, 3], [2.0, 1.0, 1.0, last_val]
        cols[1:] = np.arange(1, 1024)[:, None]
        vals[1:, 0] = 1.0
        meta = E.from_slots(cols, vals)
    else:
        rows = np.r_[0, 0, 0, 0, np.arange(1, 1024)]
        cols = np.r_[3, 5, 9, last_col, np.arange(1, 1024)]
        vals = np.r_[2.0, 1.0, 1.0, last_val, np.ones(1023)]
        meta = E.build_ellw(sp.csr_matrix(
            (vals.astype(np.float32), (rows, cols)), shape=(1024, 1024)))
    assert meta["K"] == 4
    seg = E.slot_extents(meta["idx"], meta["val"])
    assert seg[0, 0] == want_T


# ------------------------------------------------ K6's arithmetic, twin
@pytest.mark.parametrize("n", [700, 3000, 16384])
def test_trim_twin_is_the_plain_version(n):
    """Slots < T plus the one 0 * x0 term: torch.equal to
    ellw_spmv_plain on finite x."""
    op = E.EllwSpMV(E.build_ellw(delaunay(n)), device=CPU)
    assert n == 700 or (op.seg[:, 0] < op.K).any()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(n)
                         .astype(np.float32))
    assert torch.equal(trim_twin(op, x), op.plain(x))
    assert torch.equal(op.matvec(x), op.plain(x)) and op.launches == 0


def test_trim_twin_keeps_the_nonfinite_pattern():
    """x with +inf, -inf and NaN at some rows' first columns (which every
    skipped slot reads) and elsewhere: the twin gives the plain version's
    values where finite and its NaN and inf positions exactly."""
    n = 16384
    lap = delaunay(n)
    op = E.EllwSpMV(E.build_ellw(lap), device=CPU)
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    first = lap.indices[lap.indptr[:-1]]
    gen = np.random.default_rng(4)
    for value, count in ((np.inf, 5), (-np.inf, 5), (np.nan, 5)):
        x[first[gen.integers(0, n, count)]] = value
        x[gen.integers(0, n, count)] = value
    xt = torch.from_numpy(x)
    got, want = trim_twin(op, xt), op.plain(xt)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert torch.equal(got[fin], want[fin])


def test_trim_twin_matches_the_interpreted_kernel(monkeypatch):
    """The twin against proto_ellw.py's make_call in interpret mode on the
    3,000-point Delaunay Laplacian (as tests/test_torch_scratch.py runs
    it): within 1e-5 * max|y|."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: real(
        *a, **dict(kw, interpret=True)))
    spec = importlib.util.spec_from_file_location(
        "scratch_proto_ellw_trim", os.path.join(ROOT, "scratch",
                                                "proto_ellw.py"))
    pe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pe)
    lap = delaunay(3000)
    meta = pe.build_ellw(lap)
    x = np.random.default_rng(1).standard_normal(3000).astype(np.float32)
    x_pad = np.zeros(meta["L"] + meta["W"], np.float32)
    x_pad[:3000] = x
    call = pe.make_call(meta, interpret=True)
    want = np.asarray(call(*(jnp.asarray(meta[k]) for k in (
        "start", "bounds", "idx", "val")), jnp.asarray(x_pad))).reshape(
        -1)[:3000]
    got = trim_twin(E.EllwSpMV(E.build_ellw(lap), device=CPU),
                    torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_trimmed_launch_refuses_wrong_extents():
    """The raw launch refuses a CPU tensor; the shared-memory budget
    holds two 1024-thread blocks an SM, in whole 128-word chunks."""
    op = E.EllwSpMV(E.build_ellw(delaunay(3000)), device=CPU)
    x = torch.zeros(3000)
    with pytest.raises(ValueError, match="not CUDA"):
        E.ellw_cuda(op.idx, op.val, op.start, x, op.W, True, op.seg)
    assert 2 * (E.ELLW_SMEM_BYTES + 16 + 1024) <= 228 * 1024
    assert E.ELLW_SMEM_BYTES % 512 == 0


# ------------------------------------------------------ K8's lane slabs
@pytest.mark.parametrize("R,n_blocks", [(8, 8), (512, 2)])
def test_slab_twin_is_the_plain_version(R, n_blocks):
    """The lane-slab gather is torch.equal to axis0_plain on the probe's
    inputs; the wrapper takes the slab path at both R, and GatherProbe
    runs the plain version on CPU tensors, uncounted."""
    win, idx = (torch.from_numpy(a) for a in
                probe_dyngather.axis0_inputs(R, n_blocks))
    assert torch.equal(slab_twin(win, idx), axis0_plain(win, idx))
    assert axis0_path(R) == "slab"
    probe = GatherProbe()
    assert torch.equal(probe.axis0(win, idx), axis0_plain(win, idx))
    assert probe.launches["axis0"] == 0


def test_slab_limit():
    """A slab of R rows takes R * 128 bytes: up to R = 1,816 it fits a
    block's 227 KB, past it K8 reads win through the read-only cache."""
    assert GATHER_SLAB_BYTES == 227 * 1024
    assert axis0_path(1816) == "slab"
    assert axis0_path(1817) == "read-only cache"
    win, idx = (torch.from_numpy(a) for a in
                probe_dyngather.axis0_inputs(1817, 1))
    assert torch.equal(slab_twin(win, idx), axis0_plain(win, idx))
