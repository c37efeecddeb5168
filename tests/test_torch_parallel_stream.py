"""K2 per shard (`gnnla_tpu_torch.parallel.stream`), its VJP, the sharded
two-grid cycle on it and the sharded hardware check, against the JAX
package's sharded stream path on the CPU.

The port runs S = 2 and 4 gloo ranks (spawned once per world size for the
whole module, tests/test_torch_parallel_worker.py), where K2's wrapper
runs its plain version on CPU tensors; JAX runs the same numpy-seeded
inputs on `Mesh(jax.devices()[:S])` with its Pallas kernel in interpret
mode, as tests/test_parallel_stream.py does. The geometry (padded length,
halo tiles, RCM permutation) must equal JAX's; values within that test's
tolerances, stated in each test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import gnnla_tpu.parallel as jpar
from gnnla_tpu.models import residual as j_residual
from gnnla_tpu.models import setup_twogrid as j_twogrid
from gnnla_tpu.models import vcycle as j_vcycle
from gnnla_tpu.ops.pallas_stream import rcm_csr as j_rcm
from gnnla_tpu.ops.sparse import SparseOperator as JSparse

import test_torch_parallel_worker as W

WORLDS = (2, 4)
SUITE = "stream"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("parallel_stream"))
    ctxs = {S: W.start(SUITE, S, run_dir) for S in WORLDS}
    return run_dir, {S: W.join(ctx, 120) for S, ctx in ctxs.items()}


def res(ranks, S, case, rank=0):
    return W.result(ranks[0], SUITE, S, case, rank)


def jmesh(S):
    return Mesh(np.array(jax.devices()[:S]), axis_names=("rows",))


@pytest.mark.parametrize("S", WORLDS)
def test_ranks_ran_every_case(ranks, S):
    assert ranks[1][S] is None, ranks[1][S]
    for r in range(S):
        for case in ("stream", "stream_vjp", "stream_vcycle",
                     "hardware_check"):
            res(ranks, S, case, r)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stream_parity(ranks, S):
    """9000 rows (not a tile multiple), bandwidth 9, scrambled: the
    padded length, halo tiles, RCM order and nonzeros equal JAX's build;
    y within rtol 2e-5, atol 2e-5 max|y| of scipy and of JAX's sharded
    apply (test_parallel_stream.py)."""
    got = res(ranks, S, "stream")
    A = W.banded_unstructured(9000, 9, seed=0)
    kern = jpar.build_sharded_stream(A, jmesh(S), "rows", interpret=True)
    assert int(got["h_tiles"]) == kern.h_tiles >= 1
    assert int(got["t_global"]) == kern.t_global
    assert int(got["nnz"]) == kern.nnz
    np.testing.assert_array_equal(got["perm"], kern.perm)
    x = np.random.default_rng(1).standard_normal(9000).astype(np.float32)
    ref = A @ x
    for want in (ref, kern.matvec(x)):
        np.testing.assert_allclose(got["y"], want, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())
    assert int(got["launches"]) == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stream_chained_applies_and_min_halo(ranks, S):
    """Three chained applies on the rank blocks == A^3 x (rtol 1e-4, atol
    1e-5); min_halo_tiles=1 keeps a ring exchange where a banded matrix
    needs none, as in JAX."""
    got = res(ranks, S, "stream")
    A = W.banded_unstructured(8192, 5, seed=2)
    A = (A * (0.2 / np.abs(A).sum(axis=1).max())).tocsr()
    x = np.random.default_rng(3).standard_normal(8192).astype(np.float32)
    xp = x.copy()
    for _ in range(3):
        xp = A @ xp
    np.testing.assert_allclose(got["chained"], xp, rtol=1e-4, atol=1e-5)
    plain = W.banded_unstructured(9000, 3, seed=0, scramble=False)
    assert int(got["min_halo"]) == jpar.build_sharded_stream(
        plain, jmesh(S), "rows", interpret=True,
        min_halo_tiles=1).h_tiles == 1


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stream_rejects_wide_bandwidth(ranks, S):
    """A uniformly random pattern: refused (ValueError) where JAX refuses
    it — from 4 shards on; 2 shards take it, each halo a whole neighbour
    block, in both packages."""
    got = str(res(ranks, S, "stream")["wide"])
    want = W.raised(lambda: jpar.build_sharded_stream(
        W.wide_band(), jmesh(S), "rows", interpret=True))
    assert got.split(":")[0] == want.split(":")[0]
    if S >= 4:
        assert got.startswith("ValueError: ")
        assert "halo reach" in got or "column window" in got
    else:
        assert got == ""


@pytest.mark.parametrize("S", WORLDS)
def test_stream_scaling_model_fields(ranks, S):
    """The model's fields: ndev, efficiencies in (0, 1], the halo bytes
    of JAX's model (the same h tiles), a positive rate."""
    m = res(ranks, S, "stream")["model"]
    A = W.banded_unstructured(9000, 9, seed=0)
    kern = jpar.build_sharded_stream(A, jmesh(S), "rows", interpret=True)
    want = jpar.stream_scaling_model(kern)
    assert int(m[0]) == want["ndev"] == S
    assert 0 < m[3] <= 1 and 0 < m[4] <= 1
    assert m[2] == want["comm_bytes_per_chip"] == 2 * kern.h_tiles * 1024 * 4
    assert m[5] > 0


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stream_vjp_x_cotangent(ranks, S):
    """d/dx sum(w * (A x)) == A^T w through K2 on the transposed shards
    and the reversed halo exchange (rtol 2e-4, atol 2e-4 max); the
    differentiable apply's forward equals apply."""
    got = res(ranks, S, "stream_vjp")
    A = W.banded_unstructured(9000, 9, seed=2)
    rng = np.random.default_rng(3)
    rng.standard_normal(9000)
    w = rng.standard_normal(9000).astype(np.float32)
    want = A.T @ w
    assert int(got["h_tiles"]) >= 1
    assert float(got["fwd_gap"]) == 0.0
    np.testing.assert_allclose(got["xbar"], want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stream_vjp_vals_cotangent(ranks, S):
    """Per-entry values cotangent == ybar[row] * x[col] (the dense
    oracle), on every entry of the RCM-ordered padded operator (rtol
    2e-4, atol 2e-4), gathered from every rank's shard."""
    A = W.banded_unstructured(6000, 7, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(6000).astype(np.float32)
    w = rng.standard_normal(6000).astype(np.float32)
    parts = [res(ranks, S, "stream_vjp", r) for r in range(S)]
    perm = parts[0]["perm"]
    A2, perm_j = j_rcm(A)
    np.testing.assert_array_equal(perm, perm_j)
    N = int(parts[0]["padded_len"])
    xk, wk = np.zeros(N, np.float32), np.zeros(N, np.float32)
    xk[:6000], wk[:6000] = x[perm], w[perm]
    got = {}
    for p in parts:
        for i, j, g in zip(p["dv_row"], p["dv_col"], p["dv"]):
            got[(int(i), int(j))] = got.get((int(i), int(j)), 0.0) + float(g)
    Ak = A2.tocoo()
    for i, j in zip(Ak.row, Ak.col):
        assert (i, j) in got, (i, j)
        np.testing.assert_allclose(got[(i, j)], wk[i] * xk[j], rtol=2e-4,
                                   atol=2e-4)
    # the rest are the padded rows' unit diagonal (x is 0 there)
    assert len(got) == Ak.nnz + (N - 6000)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stream_vcycle_parity(ranks, S):
    """The scrambled 96^2 Laplacian's PMIS two-grid cycle with the fine
    level on K2 shards: 2 cycles within rtol 2e-4, atol 2e-4 max|x| of
    JAX's sharded stream cycle and the single-device vcycle; the residual
    falls below 0.9 of the start (test_parallel_stream.py)."""
    got = res(ranks, S, "stream_vcycle")
    Ah, rng = W.scrambled_laplacian(96, seed=0)
    A = JSparse.from_scipy(Ah)
    setup = j_twogrid(A, theta=0.25, splitting="pmis", seed=0)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    x0 = rng.standard_normal(A.n_rows).astype(np.float32)
    cycle, kern = jpar.make_sharded_stream_vcycle(setup, jmesh(S), "rows",
                                                  interpret=True)
    assert int(got["h_tiles"]) == kern.h_tiles >= 1
    x3 = kern.shard(kern.to_padded(x0))
    b3 = kern.shard(kern.to_padded(b))
    x_ref = jnp.asarray(x0)
    for _ in range(2):
        x3 = cycle(b3, x3)
        x_ref = j_vcycle(setup, jnp.asarray(b), x_ref)
    x_ref = np.asarray(x_ref)
    for want in (kern.from_padded(x3), x_ref):
        np.testing.assert_allclose(got["x"], want, rtol=2e-4,
                                   atol=2e-4 * np.abs(x_ref).max())
    r0 = np.linalg.norm(np.asarray(j_residual(A, jnp.asarray(b),
                                              jnp.asarray(x0))))
    r2 = np.linalg.norm(np.asarray(j_residual(A, jnp.asarray(b),
                                              jnp.asarray(got["x"]))))
    assert r2 < 0.9 * r0, (r0, r2)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_hardware_check(ranks, S):
    """`run_sharded_hardware_check` on the ranks (CPU): its four families
    pass with the bounds of tests/test_hardware_check.py, on every rank
    alike."""
    for r in range(S):
        got = res(ranks, S, "hardware_check", r)
        assert bool(got["ok"]) and int(got["ndev"]) == S
        assert str(got["backend"]) == "gloo"
        assert got["stream_spmv_rel_err"] < 1e-5
        assert got["stream_vjp_x_rel_err"] < 1e-5
        assert got["stream_vjp_vals_sum_rel_err"] < 1e-5
        assert got["stream_vcycle_rel_err"] < 1e-4
        assert got["stencil_rel_err"] < 1e-5


def test_hardware_check_runs_alone():
    """`python -m gnnla_tpu_torch.parallel.hardware_check --device cpu`:
    a world of one rank that the module starts and ends itself; rank 0
    prints the check's dict."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-m", "gnnla_tpu_torch.parallel.hardware_check",
         "--device", "cpu", "--n-stream", "96"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["ok"] and got["ndev"] == 1 and got["backend"] == "gloo"
    assert got["stream_spmv_rel_err"] < 1e-5
