"""Kernel K2's row blocks (`ops/stream_spmv.py::csr_row_blocks`) and the
arithmetic of its block walk (`csrc/csr_spmv.cu`) on the CPU.

The CSRs: P, P^T and the RCM-ordered A of the CLJP setup of the 40^2
Laplacian (the fast cycle's and the stream leg's K2 operands), a CSR with
empty rows, a power-law pattern with rows of 1 to 10,000 nonzeros, and a
CSR shaped as the 3-D SA hierarchy's second coarse level (rows of 33 to
120 nonzeros, the long ones in clusters between short ones). The row
blocks must hold every row exactly once and in order, keep the budget,
put each row of LONG_ROW + 1 to WARP_ROW nonzeros in a warp block of at
most BLOCK_WARPS rows, give each longer row a block of its own, and,
where no row is longer than LONG_ROW, be the blocks of the short-row rule
alone (`short_row_blocks`, the rule before warp blocks).

`block_walk` below emulates the kernel: per block, the products
v * x[col] rounded once, then each short row's sum in CSR order from 0;
a warp block's rows each summed by a warp, 32 products at a time added
in order; a long row summed by 256 strided partial sums and a fixed tree.
On every row but the long ones it must equal a sequential float32 sum
bit for bit (the kernel's arithmetic, as `chip_smoke.py::csr_sequential`
holds it on the card); everything within rtol 1e-5, atol 1e-5 * max|y|
of the plain version and of the JAX package's `StreamSpMV` (its numpy
emulator): the sums run in other orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from chip_smoke import sa_coarse_csr, short_row_blocks
from gnnla_tpu.ops.pallas_stream import StreamSpMV
from gnnla_tpu_torch.models.vcycle import setup_twogrid, setup_with_stream_p
from gnnla_tpu_torch.ops.stream_op import stream_operator
from gnnla_tpu_torch.ops.stream_spmv import (BLOCK_NNZ, BLOCK_ROWS,
                                             BLOCK_WARPS, LONG_ROW,
                                             WARP_ROW, CsrSpMV, block_forms,
                                             csr_row_blocks, csr_spmv_plain,
                                             entry_rows)
from gnnla_tpu_torch.problems import laplacian_2d

RTOL = 1e-5
CASES = ["P", "Pt", "A_rcm", "A_rcm_T", "empty_rows", "power_law",
         "sa_coarse"]
SHORT_ONLY = ["P", "Pt", "A_rcm", "A_rcm_T", "empty_rows"]


@functools.lru_cache(maxsize=None)
def fast_csrs():
    """The CsrSpMVs of P, P^T, A_rcm and A_rcm^T at 40^2, on the CPU."""
    A = laplacian_2d(40, device="cpu").eliminate_zeros()
    setup = setup_with_stream_p(setup_twogrid(A, theta=0.25,
                                              splitting="cljp", seed=0))
    S = stream_operator(A, reorder=True)
    return dict(P=setup.P.fwd, Pt=setup.P.bwd, A_rcm=S.fwd, A_rcm_T=S.bwd)


def power_law(n=12_000, seed=0):
    """Row lengths from 1 to 10,000 (a Zipf tail, two rows pinned at the
    ends), distinct columns anywhere, normal values."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, n), 10_000)
    lens[[17, 4000]] = [10_000, 1]
    rows = np.repeat(np.arange(n), lens)
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in lens])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sort_indices()
    return A


def with_empty_rows(n=3000, seed=1):
    """Rows of 0 to 9 nonzeros, a third of them empty, runs of empty rows
    at the start and the end."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 10, n) * (rng.random(n) > 0.33)
    lens[:40] = 0
    lens[-40:] = 0
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


@functools.lru_cache(maxsize=None)
def case_csr(case):
    if case == "power_law":
        return CsrSpMV(power_law(), device="cpu")
    if case == "empty_rows":
        return CsrSpMV(with_empty_rows(), device="cpu")
    if case == "sa_coarse":
        return CsrSpMV(sa_coarse_csr(3000, 2), device="cpu")
    return fast_csrs()[case]


def reference_blocks(row_ptr, budget=BLOCK_NNZ):
    """The row-block rule walked row by row in plain Python: a row of more
    than WARP_ROW nonzeros alone; a row of LONG_ROW + 1 to WARP_ROW starts
    a warp block of it and the next rows, up to BLOCK_WARPS, ending before
    a row of more than WARP_ROW; other rows in runs as `short_row_blocks`
    has them."""
    rp = row_ptr.tolist()
    n = len(rp) - 1
    lens = [rp[r + 1] - rp[r] for r in range(n)]
    w = budget - LONG_ROW
    bounds, r, run = [], 0, None  # run: (window, aligned run) of a run
    while r < n:
        if lens[r] > WARP_ROW:
            bounds.append(r)
            r, run = r + 1, None
        elif lens[r] > LONG_ROW:
            bounds.append(r)
            end = r + 1
            while end < min(r + BLOCK_WARPS, n) and lens[end] <= WARP_ROW:
                end += 1
            r, run = end, None
        else:
            key = (rp[r] // w, r // BLOCK_ROWS)
            if key != run:
                bounds.append(r)
                run = key
            r += 1
    return torch.tensor(bounds + [n], dtype=torch.int32)


def block_walk(csr, x):
    """K2's arithmetic in plain PyTorch (see the module doc)."""
    rp = csr.row_ptr.long()
    prod = csr.vals * x[csr.cols.long()]  # each product rounded once
    y = torch.zeros(csr.shape[0])
    bounds = csr.row_blocks.tolist()
    forms = block_forms(csr.row_ptr, csr.row_blocks).tolist()
    for r0, r1, form in zip(bounds[:-1], bounds[1:], forms):
        p0, p1 = int(rp[r0]), int(rp[r1])
        if form == 1:  # warp w: row r0 + w, 32 lanes' products a step
            for r in range(r0, r1):
                acc = torch.zeros(())
                for q in range(int(rp[r]), int(rp[r + 1]), 32):
                    lanes = prod[q:min(q + 32, int(rp[r + 1]))]
                    for v in lanes:  # broadcast by shuffles, in order
                        acc = acc + v
                y[r] = acc
            continue
        if form == 2:
            part = torch.zeros(256)
            for t in range(256):  # thread t: nonzeros t, t + 256, ...
                acc = torch.zeros(())
                for v in prod[p0 + t:p1:256]:
                    acc = acc + v
                part[t] = acc
            # the block's tree: warps by shuffles, then the warps' sums
            warps = part.reshape(8, 32)
            for o in (16, 8, 4, 2, 1):
                warps[:, :o] = warps[:, :o] + warps[:, o:2 * o]
            s = warps[:, 0].clone()
            for o in (4, 2, 1):
                s[:o] = s[:o] + s[o:2 * o]
            y[r0] = s[0]
            continue
        for r in range(r0, r1):
            acc = torch.zeros(())
            for v in prod[int(rp[r]):int(rp[r + 1])]:
                acc = acc + v
            y[r] = acc
    return y


def sequential(csr, x):
    """y[r] = (((0 + v0 x0) + v1 x1) + ...) in float32, in CSR order."""
    rp, cols = csr.row_ptr.numpy(), csr.cols.numpy()
    vals, xn = csr.vals.numpy(), x.numpy()
    y = np.zeros(csr.shape[0], np.float32)
    for r in range(csr.shape[0]):
        acc = np.float32(0)
        for p in range(rp[r], rp[r + 1]):
            acc = np.float32(acc + np.float32(vals[p] * xn[cols[p]]))
        y[r] = acc
    return torch.from_numpy(y)


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_row_blocks_cover_every_row_once_within_the_budget(case):
    csr = case_csr(case)
    rb = csr.row_blocks
    assert rb.dtype == torch.int32 and rb.device == csr.row_ptr.device
    b = rb.long()
    n = csr.shape[0]
    # every row exactly once, in order
    assert int(b[0]) == 0 and int(b[-1]) == n and bool((b.diff() > 0).all())
    rp = csr.row_ptr.long()
    lens = rp.diff()
    nnz = rp[b[1:]] - rp[b[:-1]]
    rows = b.diff()
    form = block_forms(csr.row_ptr, rb)
    block_of = torch.repeat_interleave(torch.arange(rows.numel()), rows)
    long_, mid = lens > WARP_ROW, (lens > LONG_ROW) & (lens <= WARP_ROW)
    # a long row is a block of its own, the whole block's; no other block
    # holds one
    alone = (rows == 1) & long_[b[:-1]]
    assert torch.equal(alone, form == 2)
    assert int(alone.sum()) == int(long_.sum()) == csr.long_rows
    # every row of LONG_ROW + 1 to WARP_ROW nonzeros in a warp block of at
    # most BLOCK_WARPS rows, and the short-row runs within the budget
    assert bool((form[block_of[mid]] == 1).all())
    assert bool((rows[form == 1] <= BLOCK_WARPS).all())
    assert bool((nnz[form == 0] < BLOCK_NNZ).all())
    assert bool((lens[form[block_of] == 0] <= LONG_ROW).all())
    assert bool((rows <= BLOCK_ROWS).all())
    # the rule walked row by row; a pure function of row_ptr
    assert torch.equal(rb, reference_blocks(csr.row_ptr))
    assert torch.equal(csr_row_blocks(csr.row_ptr), rb)
    # the warp blocks' rows and nonzeros, counted from row_ptr
    in_warp = form[block_of] == 1
    assert csr.warp_rows == int(in_warp.sum())
    assert csr.warp_nnz == int(lens[in_warp].sum())
    assert (csr.warp_rows > 0) == bool(mid.any())


@pytest.mark.parametrize("case", SHORT_ONLY)
def test_row_blocks_without_long_rows_are_the_short_row_rule(case):
    """No row of more than LONG_ROW nonzeros: the blocks of the rule
    before warp blocks, short-row runs alone."""
    csr = case_csr(case)
    assert int(csr.row_ptr.long().diff().max()) <= LONG_ROW
    assert torch.equal(csr.row_blocks, short_row_blocks(csr.row_ptr))
    assert bool((block_forms(csr.row_ptr, csr.row_blocks) == 0).all())
    assert csr.warp_rows == csr.warp_nnz == csr.long_rows == 0


def test_sa_coarse_packs_its_long_rows_into_warp_blocks():
    """The SA-coarse-level shape: most rows in warp blocks, several rows a
    block, where a block for each long row would take more than twice as
    many."""
    csr = case_csr("sa_coarse")
    lens = csr.row_ptr.long().diff()
    assert int(lens.min()) >= 33 and int(lens.max()) <= 120
    n_blocks = csr.row_blocks.shape[0] - 1
    before = short_row_blocks(csr.row_ptr).shape[0] - 1
    assert csr.warp_rows > csr.shape[0] // 2 and csr.long_rows == 0
    assert 2 * n_blocks < before


def test_power_law_has_long_rows_and_packs_the_short_ones():
    csr = case_csr("power_law")
    lens = csr.row_ptr.long().diff()
    assert int(lens.max()) == 10_000 and int(lens.min()) == 1
    assert csr.long_rows > 10 and csr.warp_rows > 10
    assert csr.row_blocks.shape[0] - 1 < csr.shape[0] // 4


def test_row_blocks_of_tiny_and_empty_csrs():
    for indptr, want in (([0], [0]), ([0, 0], [0, 1]), ([0, 0, 0], [0, 2]),
                         ([0, 65, 65], [0, 2]), ([0, 64, 64], [0, 2]),
                         ([0, 1025, 1025], [0, 1, 2]),
                         ([0, 1, 66, 67, 1100, 1200], [0, 1, 3, 4, 5])):
        got = csr_row_blocks(torch.tensor(indptr, dtype=torch.int32))
        assert got.tolist() == want, (indptr, got)
    with pytest.raises(ValueError, match="budget"):
        csr_row_blocks(torch.zeros(3, dtype=torch.int32), budget=LONG_ROW)


def test_budget_bounds_the_blocks():
    """A smaller budget cuts more blocks, each within it."""
    csr = case_csr("A_rcm")
    rp = csr.row_ptr.long()
    for budget in (80, 200, 4096):
        b = csr_row_blocks(csr.row_ptr, budget).long()
        assert bool(((rp[b[1:]] - rp[b[:-1]]) < budget).all())
    assert (csr_row_blocks(csr.row_ptr, 80).shape[0]
            > csr.row_blocks.shape[0])


@pytest.mark.parametrize("case", CASES)
def test_block_walk_is_the_sequential_sum(case):
    """Rows of at most WARP_ROW nonzeros (a thread's or a warp's) bitwise
    the CSR-order float32 sum; longer rows (the power-law pattern's)
    within rtol."""
    csr = case_csr(case)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        csr.shape[1]).astype(np.float32))
    got, want = block_walk(csr, x), sequential(csr, x)
    short = csr.row_ptr.long().diff() <= WARP_ROW
    assert torch.equal(got[short], want[short])
    assert_close(got, want)
    plain = csr_spmv_plain(entry_rows(csr.row_ptr, csr.nnz), csr.cols,
                           csr.vals, x, csr.shape[0])
    assert_close(got, plain)
    assert torch.equal(csr(x), plain)  # the CPU path runs the plain version
    assert csr.launches == 0


@pytest.mark.parametrize("case", ["A_rcm", "A_rcm_T", "power_law",
                                  "sa_coarse"])
def test_block_walk_matches_jax_stream_spmv(case):
    """The square CSRs on the JAX package's stream SpMV (emulator)."""
    csr = case_csr(case)
    n = csr.shape[0]
    B = sp.csr_matrix((csr.vals.numpy(), csr.cols.numpy(),
                       csr.row_ptr.numpy()), shape=csr.shape)
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    want = StreamSpMV(B, backend="emulate").matvec(jnp.asarray(x))
    assert_close(block_walk(csr, torch.from_numpy(x)), want)
