"""Parity of the port's automatic layout choice (`AutoTwoGrid`,
`setup_auto`), its RCM ordering (`rcm_csr`) and the square stream path
(`stream_operator(reorder=True)`, `setup_with_stream`) with the JAX
package on the CPU.

Each operator is built by the JAX package and carried across as COO
triplets. The JAX side runs kernel K4 in Pallas interpret mode and the
stream kernel on its numpy emulator (`backend="emulate"`); the port runs
its kernels' plain versions on CPU tensors.

Tolerances: rtol 1e-5, atol 1e-5 * max|y| for one operator apply; rtol
1e-4, atol 1e-5 * max|x| for 2-cycle solves (the JAX package's own cycle
tolerance) — the two sides sum in different orders in f32.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu.problems import laplacian_nd
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.ops.stream_op import StreamOperator, stream_operator
from gnnla_tpu_torch.ops.stream_spmv import rcm_csr

jv = importlib.import_module("gnnla_tpu.models.vcycle")
tv = importlib.import_module("gnnla_tpu_torch.models.vcycle")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def assert_close(got, want, rtol, atol_scale):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def carry(op_j):
    rows, cols, vals = op_j.host_coo()
    return TSparse.from_coo(rows, cols, vals, op_j.shape, device="cpu")


def permuted_grid(h=70, w=60, seed=0):
    """A 5-point Laplacian on an h x w grid (not square) with its vertices
    shuffled: an unstructured graph to every probe but RCM, which restores
    a narrow band."""
    def lap1d(m):
        return sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], (m, m))

    A = sp.kron(sp.eye(h), lap1d(w)) + sp.kron(lap1d(h), sp.eye(w))
    p = np.random.default_rng(seed).permutation(h * w)
    A = A.tocsr()[p][:, p].tocoo()
    return JSparse.from_coo(A.row, A.col, A.data, A.shape)


def random_graph(n=600, seed=3):
    """A small random symmetric graph with a dominant diagonal: no grid,
    too many offsets for DIA, too small for the stream kernel."""
    R = sp.random(n, n, density=0.02, random_state=seed, format="csr")
    A = (R + R.T + 20 * sp.eye(n)).tocoo()
    return JSparse.from_coo(A.row, A.col, A.data, A.shape)


def operator(kind):
    if kind == "grid":
        return j_laplacian_2d(24).eliminate_zeros()
    if kind == "banded":  # 1-D Laplacian: banded, n not a square
        return laplacian_nd((37 * 41,))[0].eliminate_zeros()
    if kind == "unstructured_large":
        return permuted_grid()
    if kind == "unstructured_small":
        return random_graph()
    raise KeyError(kind)


WANT = {"grid": "stencil", "banded": "dia", "unstructured_large": "stream",
        "unstructured_small": "coo"}


@pytest.mark.parametrize("kind", list(WANT))
def test_auto_picks_the_jax_layout_and_solves_alike(kind):
    A_j = operator(kind)
    auto_j = jv.setup_auto(A_j, seed=0, stream_backend="emulate")
    auto_t = tv.setup_auto(carry(A_j), seed=0)
    assert auto_j.layout == WANT[kind], auto_j.why
    assert auto_t.layout == auto_j.layout, auto_t.why
    assert auto_t.why == auto_j.why
    b = np.random.default_rng(1).standard_normal(A_j.n_rows).astype(
        np.float32)
    got = auto_t.solve(torch.from_numpy(b), torch.zeros(A_j.n_rows),
                       n_cycles=2)
    want = auto_j.solve(jnp.asarray(b), jnp.zeros(A_j.n_rows), n_cycles=2)
    assert_close(got, want, 1e-4, 1e-5)
    one = auto_t.run(torch.from_numpy(b), torch.zeros(A_j.n_rows))
    assert_close(one, auto_j.run(jnp.asarray(b), jnp.zeros(A_j.n_rows)),
                 1e-4, 1e-5)


def test_auto_stencil_matches_plain_vcycle():
    """The stencil layout's cycle is the generic cycle on the plain setup."""
    A_t = carry(operator("grid"))
    auto = tv.setup_auto(A_t, seed=0)
    assert auto.layout == "stencil"
    b = torch.ones(A_t.n_rows)
    want = tv.vcycle(tv.setup_twogrid(A_t, seed=0), b, torch.zeros_like(b))
    assert_close(auto.run(b, torch.zeros_like(b)), want, 2e-4, 2e-5)


def test_auto_respects_layouts_and_refuses():
    A_t = carry(operator("unstructured_small"))
    auto = tv.setup_auto(A_t, seed=0, layouts=("stencil", "stream", "coo"))
    assert auto.layout == "coo"
    assert set(auto.why) == {"stencil", "stream"}
    with pytest.raises(ValueError, match="no layout"):
        tv.setup_auto(A_t, seed=0, layouts=("stencil", "stream"))
    banded = tv.setup_twogrid(carry(operator("banded")))
    with pytest.raises(ValueError, match="plain COO setup"):
        tv.AutoTwoGrid(tv.setup_with_dia(banded))
    assert tv.AutoTwoGrid(banded, layouts=("coo",)).layout == "coo"


@pytest.mark.parametrize("kind", ["grid", "banded", "unstructured_large"])
def test_infer_grid_shape_matches(kind):
    A_j = operator(kind)
    assert tv._infer_grid_shape(carry(A_j)) == jv._infer_grid_shape(A_j)


# ------------------------------------------------------ RCM and the stream
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rcm_csr_matches(dtype):
    """float32 values take the native order when the library is present,
    float64 values scipy's: the same choice in both packages."""
    from gnnla_tpu.ops.pallas_stream import rcm_csr as j_rcm

    A = permuted_grid().to_scipy().tocsr().astype(dtype)
    A.sort_indices()
    B_t, p_t = rcm_csr(A.copy())
    B_j, p_j = j_rcm(A.copy())
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(B_t.indptr, B_j.indptr)
    np.testing.assert_array_equal(B_t.indices, B_j.indices)
    np.testing.assert_array_equal(B_t.data, B_j.data)


def test_stream_operator_reorder_matches_emulate():
    from gnnla_tpu.ops.stream_op import stream_operator as j_stream

    A_j = permuted_grid()
    s_j = j_stream(A_j, reorder=True, backend="emulate")
    s_t = stream_operator(carry(A_j))
    assert isinstance(s_t, StreamOperator) and s_t.perm is not None
    np.testing.assert_array_equal(s_t.perm.numpy(), np.asarray(s_j.perm))
    x = np.random.default_rng(2).standard_normal(A_j.n_rows).astype(
        np.float32)
    assert_close(s_t.matvec(torch.from_numpy(x)), s_j.matvec(jnp.asarray(x)),
                 1e-5, 1e-5)
    assert_close(s_t.rmatvec(torch.from_numpy(x)),
                 s_j.rmatvec(jnp.asarray(x)), 1e-5, 1e-5)
    np.testing.assert_array_equal(s_t.diagonal().numpy(),
                                  np.asarray(s_j.diagonal()))


def test_stream_operator_caller_order_matches_emulate():
    """reorder=False packs the shuffled graph as it is; both packages
    accept it (a square operator's window never exceeds its vector) and
    agree."""
    from gnnla_tpu.ops.stream_op import stream_operator as j_stream

    A_j = permuted_grid()
    s_j = j_stream(A_j, reorder=False, backend="emulate")
    s_t = stream_operator(carry(A_j), reorder=False)
    assert s_t.perm is None and s_t.iperm is None
    x = np.random.default_rng(3).standard_normal(A_j.n_rows).astype(
        np.float32)
    assert_close(s_t.matvec(torch.from_numpy(x)), s_j.matvec(jnp.asarray(x)),
                 1e-5, 1e-5)


def test_setup_with_stream_matches_emulate():
    A_j = permuted_grid()
    s_j = jv.setup_with_stream(jv.setup_twogrid(A_j, seed=0),
                               backend="emulate")
    s_t = tv.setup_with_stream(tv.setup_twogrid(carry(A_j), seed=0))
    assert isinstance(s_t.A, StreamOperator)
    b = np.random.default_rng(4).standard_normal(A_j.n_rows).astype(
        np.float32)
    got = tv.solve(s_t, torch.from_numpy(b), torch.zeros(A_j.n_rows),
                   n_cycles=2)
    want = jv.solve(s_j, jnp.asarray(b), jnp.zeros(A_j.n_rows), n_cycles=2)
    assert_close(got, want, 1e-4, 1e-5)
    with pytest.raises(ValueError, match="already swapped"):
        tv.setup_with_stream(s_t)
