"""The port's BSR operator (`gnnla_tpu_torch/ops/bsr.py`) against the JAX
package's on the CPU: every case of tests/test_bsr.py through the port.

Tolerances: `to_bsr`'s blocks, block rows and block columns bitwise the
JAX package's (each nonzero lands in its own slot, in f32; duplicates are
summed in float64 first, as np.add.at does); the RCM order and the
permuted operator identical (the same scipy call and host arithmetic);
products within rtol 1e-5, atol 1e-5 (1e-4 on the random pattern, as
tests/test_bsr.py): the block sums run in another order (`index_add_`
against jax.ops.segment_sum, bmm against einsum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnnla_tpu import SparseOperator as JOp
from gnnla_tpu.ops import bsr as j_bsr
from gnnla_tpu.problems import laplacian_2d as j_lap
from gnnla_tpu_torch.ops import bsr as t_bsr
from gnnla_tpu_torch.ops.sparse import SparseOperator as TOp
from gnnla_tpu_torch.problems import laplacian_2d as t_lap

CPU = "cpu"


def same_blocks(tb, jb):
    np.testing.assert_array_equal(tb.blocks.numpy(), np.asarray(jb.blocks))
    np.testing.assert_array_equal(tb.block_rows.numpy(),
                                  np.asarray(jb.block_rows))
    np.testing.assert_array_equal(tb.block_cols.numpy(),
                                  np.asarray(jb.block_cols))
    assert (tb.n, tb.block_size, tb.nnz, tb.n_block_rows) == \
        (jb.n, jb.block_size, jb.nnz, jb.n_block_rows)
    assert tb.blocks.dtype == torch.float32


def _random_pattern():
    S = sp.random(200, 200, density=0.05,
                  random_state=np.random.RandomState(3), format="coo")
    return JOp.from_scipy(S), TOp.from_scipy(S, device=CPU)


CASES = {  # name -> (JAX operator, port operator, block size, rtol)
    "laplacian_10": (lambda: (j_lap(10), t_lap(10, device=CPU)), 16, 1e-5),
    "nonmultiple_7": (lambda: (j_lap(7), t_lap(7, device=CPU)), 16, 1e-5),
    "random": (_random_pattern, 32, 1e-4),
}


@pytest.mark.parametrize("m", [None, 1, 5], ids=["vec", "m1", "m5"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blocks_and_products_match(case, m):
    make, B, rtol = CASES[case]
    jA, tA = make()
    jb, tb = j_bsr.to_bsr(jA, block_size=B), t_bsr.to_bsr(tA, block_size=B)
    same_blocks(tb, jb)
    rng = np.random.default_rng(0)
    shape = (tA.n_rows,) if m is None else (tA.n_rows, m)
    x = rng.random(shape).astype(np.float32)
    got = (tb @ torch.from_numpy(x)).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(jb.matvec(jnp.asarray(x))),
                               rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(got, tA.matvec(torch.from_numpy(x)).numpy(),
                               rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagonal_matches(case):
    make, B, _ = CASES[case]
    jA, tA = make()
    got = t_bsr.to_bsr(tA, block_size=B).diagonal().numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_bsr.to_bsr(jA, block_size=B).diagonal()))
    np.testing.assert_array_equal(got, tA.diagonal().numpy())


def test_duplicates_summed_as_jax_sums_them():
    """An uncoalesced operator: entries sharing a slot are summed in
    float64 in their order, then rounded once, as the JAX package does."""
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, 40, 400), rng.integers(0, 40, 400)
    vals = rng.standard_normal(400) / 3.0
    jA = JOp.from_coo(rows, cols, vals, (40, 40), coalesce=False)
    tA = TOp.from_coo(rows, cols, vals, (40, 40), coalesce=False,
                      device=CPU)
    same_blocks(t_bsr.to_bsr(tA, block_size=8),
                j_bsr.to_bsr(jA, block_size=8))


def test_rcm_reorder_reduces_blocks():
    """RCM concentrates a shuffled banded pattern back near the diagonal
    (the same order and operators as the JAX package's), reducing the BSR
    block count; the permuted matvec is consistent."""
    n = 256
    shuffle = np.random.RandomState(0).permutation(n)
    jS, jinv0 = j_bsr.permute(j_lap(16), shuffle)
    tS, tinv0 = t_bsr.permute(t_lap(16, device=CPU), shuffle)
    np.testing.assert_array_equal(tinv0, jinv0)
    perm = t_bsr.rcm_permutation(tS)
    np.testing.assert_array_equal(perm, j_bsr.rcm_permutation(jS))
    tR, tinv = t_bsr.permute(tS, perm)
    jR, jinv = j_bsr.permute(jS, perm)
    np.testing.assert_array_equal(tinv, jinv)
    for a, b in zip(tR.host_coo(), jR.host_coo()):
        np.testing.assert_array_equal(a, b)
    assert tR.vals.dtype == torch.float32 and tR.device.type == CPU

    nb_shuf = t_bsr.to_bsr(tS, block_size=32).blocks.shape[0]
    nb_rcm = t_bsr.to_bsr(tR, block_size=32).blocks.shape[0]
    assert nb_rcm < nb_shuf, (nb_rcm, nb_shuf)
    assert nb_rcm == j_bsr.to_bsr(jR, block_size=32).blocks.shape[0]

    # (P A P^T)(P x) = P (A x)
    x = np.random.default_rng(1).random(n).astype(np.float32)
    y_ref = tS.matvec(torch.from_numpy(x)).double().numpy()
    y_perm = tR.matvec(torch.from_numpy(x[perm])).numpy()
    np.testing.assert_allclose(y_perm, y_ref[perm], rtol=1e-4, atol=1e-5)


def test_refusals_match():
    tA, jA = t_lap(10, device=CPU), j_lap(10)
    with pytest.raises(ValueError) as je:
        j_bsr.to_bsr(jA, block_size=2, max_blocks=3)
    with pytest.raises(ValueError) as te:
        t_bsr.to_bsr(tA, block_size=2, max_blocks=3)
    assert str(te.value) == str(je.value)
    rect = ([0, 1], [0, 2], [1.0, 2.0], (2, 3))
    with pytest.raises(ValueError, match="square"):
        j_bsr.to_bsr(JOp.from_coo(*rect))
    with pytest.raises(ValueError, match="square"):
        t_bsr.to_bsr(TOp.from_coo(*rect, device=CPU))
    with pytest.raises(ValueError, match="rows"):
        t_bsr.to_bsr(tA, block_size=16).matvec(torch.zeros(99))


def test_to_bsr_takes_the_operators_device_or_refuses_without_a_card(
        monkeypatch):
    tA = t_lap(10, device=CPU)
    assert t_bsr.to_bsr(tA, block_size=16).device.type == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bsr.to_bsr(tA, block_size=16, device="cuda")
