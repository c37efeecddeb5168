"""The plain reference against scipy at small sizes."""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from perfbench.problems import poisson_fd as problems
from perfbench.reference.sparse import Reference


def _scipy(grid):
    rows, cols, vals, n = problems.poisson_fd(grid)
    return (rows, cols, vals, n), sp.csr_matrix((vals, (rows, cols)),
                                                shape=(n, n))


def test_matvec_and_residual_match_scipy():
    coo, A = _scipy((9, 7))
    ref = Reference(*coo, "cpu")
    x = np.random.default_rng(0).standard_normal(coo[3])
    y = ref.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=1e-14, atol=1e-14)
    b = np.random.default_rng(1).standard_normal(coo[3])
    want = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert abs(ref.rel_residual(torch.from_numpy(b), torch.from_numpy(x))
               - want) < 1e-13


def test_cg_reaches_scipy_solution():
    coo, A = _scipy((6, 5, 4))
    ref = Reference(*coo, "cpu")
    b = np.random.default_rng(2).standard_normal(coo[3])
    x, its = ref.cg(torch.from_numpy(b), tol=1e-10, max_iters=1000)
    assert 0 < its < 1000
    np.testing.assert_allclose(x.numpy(), spla.spsolve(A.tocsc(), b),
                               rtol=1e-8, atol=1e-9)
    assert ref.rel_residual(torch.from_numpy(b), x) < 1e-10


def test_bf16_is_the_precision_below():
    coo, A = _scipy((16, 16))
    ref16 = Reference(*coo, "cpu", torch.bfloat16)
    x = torch.randn(coo[3], generator=torch.Generator().manual_seed(3))
    err = (ref16.matvec(x).double().numpy() - A @ x.double().numpy())
    rel = np.abs(err).max() / np.abs(A @ x.double().numpy()).max()
    assert 1e-4 < rel < 5e-2
