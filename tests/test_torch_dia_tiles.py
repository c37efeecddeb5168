"""K1's tile-compressed layout (`ops/dia_spmv.py::dia_tiles`, the storage
the CUDA kernel reads) against the JAX package on the CPU.

The operators: the CLJP Ac of the 40^2 Laplacian, each level of the 64^2
SA hierarchy (all four are banded enough for K1), and a random banded
matrix of 300 rows (not a multiple of the 32-row tile) with explicit
zeros and diagonals that vanish on some whole tiles, each with f32 and
bf16 diagonals. The JAX side is `PallasDiaSpMV` in interpret mode (the real
kernel) and its `dia_transpose`, on the same COO entries carried across.

The layout must be exact: scattered back it gives the dense diagonals
bit for bit, with one segment per (tile, diagonal) that holds a nonzero.
A plain walk over the segments (the test's own helper, in the kernel's
order) must give `dia_matvec` and the Pallas kernel's y within rtol 1e-6,
atol 1e-6 * max|y|: it sums the same products in the same k order as
`dia_matvec`, and the Pallas kernel sums them in f32 in its own order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.ops.dia import dia_transpose as j_dia_transpose
from gnnla_tpu.ops.dia import to_dia as j_to_dia
from gnnla_tpu.ops.pallas_spmv import make_dia_spmv_padded
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu_torch.models.multigrid import setup_sa_multigrid
from gnnla_tpu_torch.models.vcycle import setup_twogrid
from gnnla_tpu_torch.ops.dia import dia_matvec, dia_transpose, to_dia
from gnnla_tpu_torch.ops.dia_spmv import (SPLIT_TILES, TILE,
                                          dia_kernel_operator, dia_tiles)
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.problems import laplacian_2d

CASES = ["ac40", "sa64_0", "sa64_1", "sa64_2", "sa64_3", "banded"]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def banded_coo():
    """300 rows, 9 diagonals out to +-70; each off-diagonal is explicitly
    zero on alternate runs of 40 rows (some whole tiles hold nothing of
    it) and the main diagonal on every 7th row."""
    n = 300
    rng = np.random.default_rng(12)
    offs = np.array([-70, -33, -5, -1, 0, 1, 4, 31, 64])
    rows = np.repeat(np.arange(n), offs.size)
    k = np.tile(np.arange(offs.size), n)
    cols = rows + offs[k]
    keep = (cols >= 0) & (cols < n)
    rows, cols, k = rows[keep], cols[keep], k[keep]
    vals = rng.uniform(-1.5, 1.5, rows.size)
    vals[(cols != rows) & ((rows // 40 + k) % 2 == 0)] = 0.0
    vals[(cols == rows) & (rows % 7 == 0)] = 0.0
    return rows, cols, vals, (n, n)


@functools.lru_cache(maxsize=None)
def operator_coo(case):
    """The case's COO entries (rows, cols, vals, shape), as the port holds
    them."""
    if case == "banded":
        return banded_coo()
    if case == "ac40":
        A = laplacian_2d(40, device="cpu").eliminate_zeros()
        op = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0).Ac
    else:
        A = laplacian_2d(64, device="cpu").eliminate_zeros()
        op = setup_sa_multigrid(A, seed=0).As[int(case[-1])]
    return (*op.host_coo(), op.shape)


def operators(case, dtype):
    """(port K1 operator with `dtype` diagonals, JAX DIAOperator) of one
    matrix; the two packages' dense diagonals are asserted identical."""
    rows, cols, vals, shape = operator_coo(case)
    dia = to_dia(TSparse.from_coo(rows, cols, vals, shape, device="cpu"),
                 512)
    jdia = j_to_dia(JSparse.from_coo(rows, cols, vals, shape), 512)
    assert dia.offsets == tuple(int(o) for o in jdia.offsets)
    np.testing.assert_array_equal(dia.diags.numpy(), np.asarray(jdia.diags))
    return dia_kernel_operator(dia, diag_dtype=DTYPES[dtype][0]), jdia


def tile_of(tiles):
    ptr = tiles.seg_ptr.long()
    return torch.repeat_interleave(torch.arange(ptr.shape[0] - 1),
                                   ptr.diff())


def scatter(tiles, offsets):
    """The dense [K, n_tiles * 32] array the segments describe."""
    n_tiles = tiles.seg_ptr.shape[0] - 1
    dense = torch.zeros(len(offsets), n_tiles * TILE,
                        dtype=tiles.seg_vals.dtype)
    k = torch.searchsorted(torch.tensor(offsets, dtype=torch.int32),
                           tiles.seg_off)
    rows = tile_of(tiles)[:, None] * TILE + torch.arange(TILE)
    dense[k[:, None], rows] = tiles.seg_vals
    return dense


def walk(tiles, x):
    """y = A x by a plain walk over the segments in stored order: per
    segment, its 32 rows times x at the segment's offset, in range."""
    n, lane = tiles.n, torch.arange(TILE)
    y = torch.zeros(n)
    for t, off, v in zip(tile_of(tiles).tolist(), tiles.seg_off.tolist(),
                         tiles.seg_vals):
        rows = t * TILE + lane
        cols = rows + off
        ok = (rows < n) & (cols >= 0) & (cols < n)
        y.index_add_(0, rows[ok], v[ok].float() * x[cols[ok]])
    return y


def numpy_segments(diags):
    d = diags.float().numpy()
    k, n = d.shape
    n_tiles = -(-n // TILE)
    pad = np.zeros((k, n_tiles * TILE), np.float32)
    pad[:, :n] = d
    return int((pad.reshape(k, n_tiles, TILE) != 0).any(-1).sum())


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def assert_close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_segments_scatter_back_to_the_diagonals(case, dtype):
    op, _ = operators(case, dtype)
    tiles = op.tiles
    assert tiles.seg_vals.dtype == op.diags.dtype
    assert tiles.seg_ptr.dtype == tiles.seg_off.dtype == torch.int32
    dense = scatter(tiles, op.offsets)
    assert torch.equal(dense[:, :op.n], op.diags)
    assert not dense[:, op.n:].any()
    # offsets increase within each tile: the k order of dia_matvec
    same_tile = tile_of(tiles).diff() == 0
    assert bool((tiles.seg_off.diff()[same_tile] > 0).all())


@pytest.mark.parametrize("case", CASES)
def test_segment_count_is_the_nonzero_tiles(case):
    op, _ = operators(case, "f32")
    assert op.tiles.n_segs == numpy_segments(op.diags)
    assert op.tiles.split == (-(-op.n // TILE) < SPLIT_TILES)
    assert op.tiles.nbytes == (op.tiles.n_segs * (TILE * 4 + 4)
                               + (-(-op.n // TILE) + 1) * 4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_segment_walk_matches_dia_matvec_and_pallas(case, dtype,
                                                    interpret_mode):
    op, jdia = operators(case, dtype)
    x = vec(op.n, 1)
    got = walk(op.tiles, torch.from_numpy(x))
    assert_close(got, dia_matvec(op.diags, op.offsets, torch.from_numpy(x)))
    pmv = make_dia_spmv_padded(jdia, tile=1024, diag_dtype=DTYPES[dtype][1])
    assert_close(got, pmv.matvec(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_transposed_layout_is_the_compacted_transpose(case, dtype):
    """A^T's layout (x's cotangent) is the compaction of the JAX package's
    dia_transpose, and its walk is A^T w."""
    op, jdia = operators(case, dtype)
    jt = j_dia_transpose(jdia)
    want = dia_tiles(torch.from_numpy(np.array(jt.diags)).to(
        DTYPES[dtype][0]), tuple(int(o) for o in jt.offsets))
    got = op.tiles_t
    for name in ("seg_ptr", "seg_off", "seg_vals"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.n, got.split) == (want.n, want.split)
    w = vec(op.n, 2)
    dense = TSparse.from_coo(*operator_coo(case)[:3], (op.n, op.n),
                             device="cpu").to_dense().numpy()
    if dtype == "bf16":
        dense = torch.from_numpy(dense).to(torch.bfloat16).float().numpy()
    assert_close(walk(got, torch.from_numpy(w)), dense.T @ w, rtol=1e-5)


def test_in_place_update_is_in_the_next_rebuild():
    """A structural zero made nonzero in place (as a gradient step does)
    bumps the diagonals' version: the next layout has its segment, in A's
    and in A^T's, and x's cotangent sees it. Applies with no change
    rebuild nothing."""
    op, _ = operators("banded", "f32")
    x, w = torch.from_numpy(vec(op.n, 3)), torch.from_numpy(vec(op.n, 4))
    for _ in range(3):
        op.matvec(x)
        op.layouts()
    assert op.rebuilds == 0
    # rows 120-159 hold no -33 value: tile 4 (rows 128-159) has no segment
    k, row = op.offsets.index(-33), 140
    assert float(op.diags[k, 128:160].abs().max()) == 0.0
    segs, segs_t = op.tiles.n_segs, op.tiles_t.n_segs
    with torch.no_grad():
        op.diags[k, row] = 2.5
    tiles, tiles_t = op.layouts()
    assert op.rebuilds == 1
    assert tiles.n_segs == segs + 1 == numpy_segments(op.diags)
    t = dia_transpose(op.plain())
    assert tiles_t.n_segs >= segs_t
    assert torch.equal(scatter(tiles_t, t.offsets)[:, :op.n], t.diags)
    assert torch.equal(scatter(tiles, op.offsets)[:, :op.n], op.diags)
    assert_close(walk(tiles, x), dia_matvec(op.diags, op.offsets, x))
    # x's cotangent on the rebuilt A^T, against the plain twin's autograd
    x1 = x.clone().requires_grad_(True)
    torch.dot(w, op.matvec(x1)).backward()
    x2 = x.clone().requires_grad_(True)
    torch.dot(w, dia_matvec(op.diags, op.offsets, x2)).backward()
    assert_close(x1.grad, x2.grad)
    assert_close(walk(tiles_t, w), x2.grad)
    assert op.rebuilds == 1


def test_transposed_layout_is_built_at_first_use():
    """An operator applied only forward never builds A^T's layout; its
    first use builds it once and keeps it, and a rebuild of A's layout
    (an in-place update) drops it until the next use."""
    op, _ = operators("ac40", "f32")
    x = torch.from_numpy(vec(op.n, 3))
    for _ in range(2):
        op.matvec(x)
        op.layout()
    assert op._tiles_t is None and op.transposed is None
    tiles_t = op.tiles_t
    assert op.tiles_t is tiles_t and op.transposed is not None
    with torch.no_grad():
        op.diags.mul_(2.0)
    op.layout()
    assert op.rebuilds == 1 and op._tiles_t is None
    t = dia_transpose(op.plain())
    assert torch.equal(scatter(op.tiles_t, t.offsets)[:, :op.n], t.diags)
    assert op.rebuilds == 1


def test_gradient_steps_rebuild_once_each():
    """With the diagonals requiring grad (the Function receives the
    operator's own tensor), forward and backward rebuild nothing; each
    in-place optimizer step rebuilds once, and the next x cotangent is
    the updated A^T ybar."""
    op, _ = operators("ac40", "f32")
    x, w = torch.from_numpy(vec(op.n, 5)), torch.from_numpy(vec(op.n, 6))
    op.diags.requires_grad_(True)
    for step in range(2):
        x1 = x.clone().requires_grad_(True)
        torch.dot(w, op.matvec(x1)).backward()
        assert op.rebuilds == step
        d2 = op.diags.detach().clone().requires_grad_(True)
        x2 = x.clone().requires_grad_(True)
        torch.dot(w, dia_matvec(d2, op.offsets, x2)).backward()
        assert_close(x1.grad, x2.grad)
        with torch.no_grad():
            op.diags.sub_(0.1 * op.diags.grad)
        op.diags.grad = None
    op.layouts()
    assert op.rebuilds == 2
    op.diags.requires_grad_(False)


def test_replaced_diagonals_rebuild():
    op, _ = operators("sa64_2", "f32")
    op.diags = op.diags * 2.0
    tiles, _ = op.layouts()
    assert op.rebuilds == 1
    assert torch.equal(scatter(tiles, op.offsets)[:, :op.n], op.diags)


@pytest.mark.parametrize("n", [SPLIT_TILES * TILE - 1, SPLIT_TILES * TILE,
                               33, 1])
def test_split_form_is_chosen_from_n(n):
    """Fewer than SPLIT_TILES tiles take the split form; the tail tile of
    an n that is not a multiple of 32 is zero past row n."""
    diags = torch.ones(2, n)
    tiles = dia_tiles(diags, (0, 1))
    n_tiles = -(-n // TILE)
    assert tiles.split == (n_tiles < SPLIT_TILES)
    assert tiles.seg_ptr.shape == (n_tiles + 1,)
    assert tiles.n_segs == 2 * n_tiles
    assert float(tiles.seg_vals.sum()) == 2 * n
    assert tiles.seg_off.tolist()[:2] == [0, 1]



# ------------------------------------------------------- non-finite x
def nonfinite_rows(tiles, offsets, x):
    """The rows K1's repair names: r = j - off for each non-finite x[j] and
    each dense offset, in range, whose (tile of r, offset) segment the
    layout skipped. (A stored zero times inf or NaN is NaN already.)"""
    stored = set(zip(tile_of(tiles).tolist(), tiles.seg_off.tolist()))
    rows = set()
    for j in torch.nonzero(~torch.isfinite(x)).reshape(-1).tolist():
        for off in offsets:
            r = j - off
            if 0 <= r < tiles.n and (r // TILE, off) not in stored:
                rows.add(r)
    return torch.tensor(sorted(rows), dtype=torch.long)


def nonfinite_x(tiles, offsets, seed):
    """A standard normal x with +inf, -inf and NaN at three columns, each
    reached by some row through a segment the layout skipped."""
    n = tiles.n
    stored = set(zip(tile_of(tiles).tolist(), tiles.seg_off.tolist()))
    reach = sorted({r + off for r in range(n) for off in offsets
                    if 0 <= r + off < n and (r // TILE, off) not in stored})
    x = torch.from_numpy(vec(n, seed))
    cols = np.random.default_rng(seed).choice(reach, 3, replace=False)
    x[cols] = torch.tensor([float("inf"), float("-inf"), float("nan")])
    return x


def same_nonfinite(got, want):
    """Equal NaN, +inf and -inf positions; the finite entries close."""
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(want)), test.__name__
    fin = torch.isfinite(want)
    assert_close(got[fin], want[fin])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["ac40", "sa64_1", "banded"])
def test_repair_gives_the_nonfinite_pattern(case, dtype, interpret_mode):
    """The segment walk with NaN written into `nonfinite_rows` gives
    `dia_matvec`'s and the Pallas kernel's NaN and inf positions exactly,
    for A and for A^T (x's cotangent): the rows a non-finite x reaches
    only through a skipped segment exist, and the repair alone makes them
    NaN."""
    op, jdia = operators(case, dtype)
    jt = j_dia_transpose(jdia)
    t = dia_transpose(op.plain())
    for tiles, offsets, diags, j_op, seed in (
            (op.tiles, op.offsets, op.diags, jdia, 7),
            (op.tiles_t, t.offsets, t.diags, jt, 8)):
        assert tiles.offsets.tolist() == list(offsets)
        assert tiles.state.tolist() == [0, 0] and tiles.repair
        x = nonfinite_x(tiles, offsets, seed)
        walked = walk(tiles, x)
        rows = nonfinite_rows(tiles, offsets, x)
        want = dia_matvec(diags, offsets, x)
        hidden = torch.isnan(want) & ~torch.isnan(walked)
        assert bool(hidden.any())  # what the skipped segments hide
        assert torch.equal(torch.nonzero(hidden).reshape(-1),
                           rows[~torch.isnan(walked[rows])])
        walked[rows] = float("nan")
        same_nonfinite(walked, want)
        pmv = make_dia_spmv_padded(j_op, tile=1024,
                                   diag_dtype=DTYPES[dtype][1])
        same_nonfinite(walked, torch.from_numpy(np.array(
            pmv.matvec(jnp.asarray(x.numpy())))))


def test_repair_names_no_row_for_finite_x():
    op, _ = operators("ac40", "f32")
    x = torch.from_numpy(vec(op.n, 9))
    assert nonfinite_rows(op.tiles, op.offsets, x).numel() == 0


@pytest.mark.parametrize("case", CASES + ["lap40"])
def test_repair_flag_is_a_skipped_segment_in_range(case):
    """`DiaTiles.repair`: whether some row reaches a column through a
    skipped segment, counted by brute force over rows and offsets. The
    Laplacian's layouts (and the SA hierarchy's level 0, the same matrix)
    skip segments only past the first and last grid rows, and level 3 is
    one tile that keeps every diagonal: none of them needs the kernel's
    ticket."""
    if case == "lap40":
        A = laplacian_2d(40, device="cpu").eliminate_zeros()
        op = dia_kernel_operator(to_dia(A))
    else:
        op, _ = operators(case, "f32")
    t = dia_transpose(op.plain())
    for tiles, offsets in ((op.tiles, op.offsets), (op.tiles_t, t.offsets)):
        stored = set(zip(tile_of(tiles).tolist(), tiles.seg_off.tolist()))
        hidden = any(0 <= r + off < op.n and (r // TILE, off) not in stored
                     for r in range(op.n) for off in offsets)
        assert tiles.repair == hidden
        assert tiles.repair == (case not in ("lap40", "sa64_0", "sa64_3"))
