"""Parity of the PyTorch port's operators (gnnla_tpu_torch.ops) with the
JAX package on the CPU.

The same inputs, made from numpy seeds, go through both packages. The JAX
kernels run as the JAX package's own tests run them: the Pallas DIA
kernel in interpret mode, the stream kernel through its numpy emulator
(backend="emulate"). The port runs its kernels' plain PyTorch versions,
which its wrappers take for CPU tensors.

Tolerance: rtol 1e-5, atol 1e-6 * max|y| — the two sum in different
orders in f32.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.ops import sparse as j_sparse
from gnnla_tpu.ops.dia import to_dia as j_to_dia
from gnnla_tpu.ops.segment import segment_sum as j_segment_sum
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu_torch.ops.dia import to_dia as t_to_dia
from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator, dia_kernel_operator
from gnnla_tpu_torch.ops.segment import segment_sum as t_segment_sum
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.ops.stream_op import (RectStreamOperator,
                                           rect_stream_operator,
                                           stream_operator)
from gnnla_tpu_torch.ops.stream_spmv import check_stream_pattern
from gnnla_tpu_torch.problems import laplacian_2d as t_laplacian_2d

j_vcycle = importlib.import_module("gnnla_tpu.models.vcycle")
t_vcycle = importlib.import_module("gnnla_tpu_torch.models.vcycle")

CPU = "cpu"


def assert_close(got, want, rtol=1e-5, atol_scale=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


_SETUPS = {}


def _setups(n):
    """(jax setup, port setup) of the n^2 Laplacian, built once."""
    if n not in _SETUPS:
        A_j = j_laplacian_2d(n).eliminate_zeros()
        A_t = t_laplacian_2d(n, device=CPU).eliminate_zeros()
        _SETUPS[n] = (j_vcycle.setup_twogrid(A_j), t_vcycle.setup_twogrid(A_t))
    return _SETUPS[n]


def _operator(case):
    """(jax op, port op) for 'lap24', 'lap40' or 'ac24'."""
    if case == "ac24":
        s_j, s_t = _setups(24)
        return s_j.Ac, s_t.Ac
    n = int(case[3:])
    return (j_laplacian_2d(n).eliminate_zeros(),
            t_laplacian_2d(n, device=CPU).eliminate_zeros())


OPS = ["lap24", "lap40", "ac24"]


# ------------------------------------------------------------ SparseOperator
@pytest.mark.parametrize("seed", [0, 1])
def test_from_coo_coalesce_matches(seed):
    rng = np.random.default_rng(seed)
    shape = (37, 29)
    rows = rng.integers(0, shape[0], 400)
    cols = rng.integers(0, shape[1], 400)
    vals = rng.standard_normal(400)
    j = j_sparse.SparseOperator.from_coo(rows, cols, vals, shape)
    t = TSparse.from_coo(rows, cols, vals, shape, device=CPU)
    for name in ("rows", "cols", "row_ptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_allclose(t.vals.numpy(), np.asarray(j.vals), rtol=1e-6)
    for a, b in zip(t.host_coo(), j.host_coo()):
        np.testing.assert_array_equal(a, b)
    assert t.shape == j.shape and t.nnz == j.nnz


@pytest.mark.parametrize("n", [24, 40])
def test_laplacian_identical(n):
    j = j_laplacian_2d(n)
    t = t_laplacian_2d(n, device=CPU)
    for a, b in zip(t.host_coo(), j.host_coo()):
        np.testing.assert_array_equal(a, b)
    for view in ("eliminate_zeros", "remove_diagonal", "transpose"):
        tv, jv = getattr(t, view)(), getattr(j, view)()
        for a, b in zip(tv.host_coo(), jv.host_coo()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tv.row_ptr.numpy(),
                                      np.asarray(jv.row_ptr))


@pytest.mark.parametrize("case", OPS)
def test_matvec_rmatvec_diagonal(case):
    j, t = _operator(case)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(j.n_cols).astype(np.float32)
    X = rng.standard_normal((j.n_cols, 3)).astype(np.float32)
    assert_close(t.matvec(torch.from_numpy(x)), j.matvec(jnp.asarray(x)))
    assert_close(t.matvec(torch.from_numpy(X)), j.matvec(jnp.asarray(X)))
    assert_close(t.rmatvec(torch.from_numpy(x)), j.rmatvec(jnp.asarray(x)))
    np.testing.assert_array_equal(t.diagonal().numpy(),
                                  np.asarray(j.diagonal()))
    np.testing.assert_array_equal(t.host_diagonal(), j.host_diagonal())


def test_rectangular_rmatvec_and_shape_errors():
    s_j, s_t = _setups(24)
    rng = np.random.default_rng(12)
    y = rng.standard_normal(s_j.P.n_rows).astype(np.float32)
    xc = rng.standard_normal(s_j.P.n_cols).astype(np.float32)
    assert_close(s_t.P.rmatvec(torch.from_numpy(y)),
                 s_j.P.rmatvec(jnp.asarray(y)))
    assert_close(s_t.P.matvec(torch.from_numpy(xc)),
                 s_j.P.matvec(jnp.asarray(xc)))
    with pytest.raises(ValueError):
        s_t.P.matvec(torch.from_numpy(y))
    with pytest.raises(ValueError):
        s_t.P.rmatvec(torch.from_numpy(xc))


def test_segment_sum_matches():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 17, 200)
    data = rng.standard_normal((200, 4)).astype(np.float32)
    got = t_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 20)
    want = j_segment_sum(jnp.asarray(data), jnp.asarray(ids), 20)
    assert_close(got, want)
    assert np.all(got.numpy()[17:] == 0)  # empty segments are 0


# ---------------------------------------------------------------- DIA / K1
@pytest.mark.parametrize("case", OPS)
def test_to_dia_matvec_matches(case):
    j, t = _operator(case)
    dj, dt = j_to_dia(j, 512), t_to_dia(t, 512)
    assert dt.offsets == dj.offsets and dt.n == dj.n and dt.nnz == dj.nnz
    np.testing.assert_array_equal(dt.diags.numpy(), np.asarray(dj.diags))
    x = np.random.default_rng(4).standard_normal(dj.n).astype(np.float32)
    assert_close(dt.matvec(torch.from_numpy(x)), dj.matvec(jnp.asarray(x)))
    np.testing.assert_array_equal(dt.diagonal().numpy(),
                                  np.asarray(dj.diagonal()))


def test_ac24_has_33_diagonals():
    _, t = _operator("ac24")
    assert len(t_to_dia(t, 512).offsets) == 33


def test_to_dia_refuses_too_many_offsets():
    j, t = _operator("ac24")
    with pytest.raises(ValueError, match="not banded enough"):
        j_to_dia(j, 8)
    with pytest.raises(ValueError, match="not banded enough"):
        t_to_dia(t, 8)


@pytest.mark.parametrize("case", OPS)
def test_dia_kernel_operator_matches_pallas(case, interpret_mode):
    from gnnla_tpu.ops.pallas_spmv import pallas_dia_operator

    j, t = _operator(case)
    pj = pallas_dia_operator(j_to_dia(j, 512))
    pt = dia_kernel_operator(t_to_dia(t, 512))
    assert isinstance(pt, DiaKernelOperator)
    assert pt.shape == pj.shape and pt.n_rows == pj.n_rows
    x = np.random.default_rng(5).standard_normal(pj.n).astype(np.float32)
    assert_close(pt.matvec(torch.from_numpy(x)), pj.matvec(jnp.asarray(x)))
    np.testing.assert_array_equal(pt.diagonal().numpy(),
                                  np.asarray(pj.diagonal()))
    assert pt.launches == 0  # the CPU path runs the plain version
    with pytest.raises(ValueError, match="vector-only"):
        pt.matvec(torch.zeros(pj.n, 2))


# ------------------------------------------------------------- stream / K2
def _jax_rect(P_j):
    from gnnla_tpu.ops.stream_op import rect_stream_operator as j_rect

    n, nc = P_j.shape
    rows, cols, vals = P_j.host_coo()
    Psq = j_sparse.SparseOperator.from_coo(rows, cols, vals, (n, n))
    return j_rect(Psq, nc, backend="emulate"), Psq


@pytest.mark.parametrize("n", [24, 40])
def test_rect_stream_operator_matches_emulate(n):
    s_j, s_t = _setups(n)
    r_j, _ = _jax_rect(s_j.P)
    r_t = rect_stream_operator(s_t.P, s_t.P.n_cols)
    assert isinstance(r_t, RectStreamOperator)
    assert r_t.shape == r_j.shape
    assert (r_t.n_rows, r_t.n_cols) == (r_j.n_rows, r_j.n_cols)
    rng = np.random.default_rng(6)
    xc = rng.standard_normal(r_j.n_cols).astype(np.float32)
    y = rng.standard_normal(r_j.n_rows).astype(np.float32)
    assert_close(r_t.matvec(torch.from_numpy(xc)), r_j.matvec(jnp.asarray(xc)))
    assert_close(r_t.rmatvec(torch.from_numpy(y)), r_j.rmatvec(jnp.asarray(y)))
    for bad in (torch.zeros(r_j.n_cols, 2), torch.zeros(r_j.n_rows, 2)):
        with pytest.raises(ValueError):
            r_t.matvec(bad)
        with pytest.raises(ValueError):
            r_t.rmatvec(bad)


@pytest.mark.parametrize("n", [24, 40])
def test_square_embedding_is_accepted(n):
    """The port takes P rectangular or in the JAX package's square
    embedding, with the same results."""
    s_j, s_t = _setups(n)
    _, Psq = _jax_rect(s_j.P)
    rows, cols, vals = Psq.host_coo()
    Psq_t = TSparse.from_coo(rows, cols, vals, Psq.shape, device=CPU)
    a = rect_stream_operator(Psq_t, s_t.P.n_cols)
    b = rect_stream_operator(s_t.P, s_t.P.n_cols)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        b.n_cols).astype(np.float32))
    np.testing.assert_array_equal(a.matvec(x).numpy(), b.matvec(x).numpy())
    assert a.shape == b.shape


@pytest.mark.parametrize("case", ["lap24", "lap40"])
def test_square_stream_operator_matches(case):
    from gnnla_tpu.ops.stream_op import stream_operator as j_stream

    j, t = _operator(case)
    s_j = j_stream(j, reorder=False, backend="emulate")
    s_t = stream_operator(t, reorder=False)
    x = np.random.default_rng(9).standard_normal(j.n_rows).astype(np.float32)
    assert_close(s_t.matvec(torch.from_numpy(x)), s_j.matvec(jnp.asarray(x)))
    assert_close(s_t.rmatvec(torch.from_numpy(x)),
                 s_j.rmatvec(jnp.asarray(x)))
    np.testing.assert_array_equal(s_t.diagonal().numpy(),
                                  np.asarray(s_j.diagonal()))


@pytest.mark.parametrize("n", [24, 40, 64])
def test_window_width_matches_jax_packer(n):
    """check_stream_pattern computes the JAX packer's window width on the
    square embedding of P and of its transpose."""
    from gnnla_tpu.ops.pallas_stream import build_stream

    s_j, _ = _setups(n)
    _, Psq = _jax_rect(s_j.P)
    for A in (Psq.to_scipy().tocsr(), Psq.to_scipy().T.tocsr()):
        A.sort_indices()
        assert check_stream_pattern(A.indptr, A.indices, A.shape[1]) == \
            build_stream(A).w_sc


@pytest.mark.parametrize("which", ["stream_operator", "rect_stream_operator"])
def test_empty_operator_refused_by_both(which):
    from gnnla_tpu.ops import stream_op as j_stream_op

    empty = np.zeros(0, np.int64)
    j = j_sparse.SparseOperator.from_coo(empty, empty, empty, (2048, 2048))
    t = TSparse.from_coo(empty, empty, empty, (2048, 2048), device=CPU)
    if which == "stream_operator":
        with pytest.raises(ValueError, match="empty matrix"):
            j_stream_op.stream_operator(j, reorder=False, backend="emulate")
        with pytest.raises(ValueError, match="empty matrix"):
            stream_operator(t, reorder=False)
    else:
        with pytest.raises(ValueError, match="empty matrix"):
            j_stream_op.rect_stream_operator(j, 1000, backend="emulate")
        with pytest.raises(ValueError, match="empty matrix"):
            rect_stream_operator(t, 1000)
