"""The re-set-up deployment (`lognormal2d_5pt_512.resetup`) on the CPU at
small sizes: the plain reference's field and finite-volume operator
(`perfbench/problems/lognormal_fv.py`) against an independent assembly,
the port's SA hierarchy of a log-normal operator against the JAX
package's, and solves of new operators in turn through the port's
`mg_pcg`, each held to its own float64 operator.

Tolerances: the hierarchies are identical (both packages run the same
float64 host set-up and cast once, as `tests/test_torch_multigrid.py`
holds); the independent assembly agrees to 1e-12 relative (float64 sums in
another order); a solve meets the configuration's tol, 5e-4, on the true
residual against its own float64 operator.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from perfbench.problems import lognormal_fv
from perfbench.problems.poisson_fd import poisson_fd
from perfbench.reference.sparse import Reference

jm = importlib.import_module("gnnla_tpu.models.multigrid")
tm = importlib.import_module("gnnla_tpu_torch.models.multigrid")
tk = importlib.import_module("gnnla_tpu_torch.models.krylov")

TOL = 5e-4


def _coefficient(n, seed):
    g = lognormal_fv.field((n, n), 1.0, 0.3, np.random.default_rng(seed))
    return np.exp(g)


def _by_faces(a):
    """The finite-volume operator face by face (scipy LIL, no shared code
    with `assemble`): each interior face adds its harmonic mean to both
    cells' diagonals and subtracts it off the diagonal, each boundary face
    adds 2 a to its cell's diagonal."""
    nx, ny = a.shape
    A = sp.lil_matrix((nx * ny, nx * ny))
    for i in range(nx):
        for j in range(ny):
            p = i * ny + j
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                k, m = i + di, j + dj
                if 0 <= k < nx and 0 <= m < ny:
                    h = 2.0 / (1.0 / a[i, j] + 1.0 / a[k, m])
                    A[p, p] += h
                    A[p, k * ny + m] -= h
                else:
                    A[p, p] += 2.0 * a[i, j]
    return A.tocsr()


@pytest.mark.parametrize("shape", [(16, 16), (7, 5)])
def test_assembly_matches_a_face_by_face_assembly(shape):
    a = np.exp(np.random.default_rng(4).standard_normal(shape))
    rows, cols, vals, n = lognormal_fv.assemble(a)
    got = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    want = _by_faces(a)
    assert abs(got - want).max() <= 1e-12 * abs(want).max()


def test_operator_is_spd_with_the_poisson_pattern():
    rows, cols, vals, n = lognormal_fv.assemble(_coefficient(16, 1))
    p_rows, p_cols, _, p_n = poisson_fd((16, 16))
    assert n == p_n and rows.dtype == cols.dtype == np.int32
    np.testing.assert_array_equal(rows, p_rows)
    np.testing.assert_array_equal(cols, p_cols)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
    np.testing.assert_array_equal(A, A.T)
    assert np.linalg.eigvalsh(A).min() > 0


def test_constant_field_is_the_pattern_of_build():
    rows, cols, vals, n = lognormal_fv.build({"grid": [6, 4]})
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
    corner, edge, inner = A[0, 0], A[1, 1], A[5, 5]
    assert (corner, edge, inner) == (6.0, 5.0, 4.0)
    assert set(np.unique(A[A < 0])) == {-1.0}


def test_field_has_the_stated_covariance():
    """Pointwise variance sigma^2 and the covariance at distance r, over
    many samples of a small grid."""
    rng = np.random.default_rng(2)
    g = np.stack([lognormal_fv.field((16, 16), 1.0, 0.3, rng)
                  for _ in range(600)])
    assert g.var(axis=0).mean() == pytest.approx(1.0, rel=0.08)
    d = 4   # 0.25 apart on the torus
    cov = (g[:, 0, 0] * g[:, d, 0]).mean()
    assert cov == pytest.approx(np.exp(-0.25 / 0.3), abs=0.1)


def test_sa_hierarchy_of_a_lognormal_operator_is_the_jax_package_s():
    rows, cols, vals, n = lognormal_fv.assemble(_coefficient(32, 7))
    s_t = tm.setup_sa_multigrid(
        TSparse.from_coo(rows, cols, vals, (n, n), coalesce=False,
                         device="cpu"), seed=0)
    s_j = jm.setup_sa_multigrid(
        JSparse.from_coo(rows, cols, vals, (n, n), dtype=jnp.float32,
                         coalesce=False), seed=0)
    assert s_t.n_levels == s_j.n_levels >= 3
    for op_t, op_j in zip(s_t.As + s_t.Ps, s_j.As + s_j.Ps):
        assert op_t.shape == op_j.shape
        np.testing.assert_array_equal(op_t.rows.numpy(),
                                      np.asarray(op_j.rows))
        np.testing.assert_array_equal(op_t.cols.numpy(),
                                      np.asarray(op_j.cols))
        np.testing.assert_array_equal(op_t.vals.numpy(),
                                      np.asarray(op_j.vals))
    for d_t, d_j in zip(s_t.diags, s_j.diags):
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_new_operators_in_turn_each_reach_tol_on_their_own_matrix():
    """Three fields in turn, each set up anew on K1/K2's twins (their
    plain versions here) and solved by mg_pcg as the cell solves: each x
    meets tol against its own float64 operator, and against another
    field's operator it does not."""
    n_side = 48
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(
        n_side * n_side).astype(np.float32))
    mats = []
    for seed in (11, 12, 13):
        rows, cols, vals, n = lognormal_fv.assemble(
            _coefficient(n_side, seed))
        A = TSparse.from_coo(rows, cols, vals.astype(np.float32), (n, n),
                             coalesce=False, device="cpu")
        mg = tm.setup_with_dia_multigrid(tm.setup_sa_multigrid(A),
                                         kernel=True)
        x, hist = tk.mg_pcg(mg, b, torch.zeros_like(b), n_iters=10,
                            n_smooth=1, omega=0.7, coarse_deg=8)
        ref = Reference(rows, cols, vals, n, "cpu")
        assert ref.rel_residual(b, x) <= TOL
        mats.append((ref, x))
    other, _ = mats[0]
    assert other.rel_residual(b, mats[1][1]) > 10 * TOL
