"""The port's distribution (`gnnla_tpu_torch.parallel`) against the JAX
package's `gnnla_tpu.parallel` on the CPU: partitioning, the collectives,
the sharded COO SpMV, Jacobi, norm and power method, the sharded stencil,
the two-grid and multilevel cycles, mg_pcg, the scaling model and the
guards.

The port runs S = 2 and 4 gloo ranks (spawned once per world size for the
whole module, tests/test_torch_parallel_worker.py); JAX runs the same
numpy-seeded inputs on `Mesh(jax.devices()[:S])`. Partitions are compared
bit for bit; every result against the JAX sharded function and the
single-device oracle of the matching JAX test (tests/test_parallel.py),
within that test's tolerance, stated in each test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import gnnla_tpu.parallel as jpar
import gnnla_tpu_torch.parallel as tpar
from gnnla_tpu.models import jacobi as j_jacobi
from gnnla_tpu.models import power_method as j_power
from gnnla_tpu.models.multigrid import (multigrid_cycle as j_mg_cycle,
                                        multigrid_solve as j_mg_solve,
                                        setup_sa_multigrid as j_sa)
from gnnla_tpu.models.krylov import mg_pcg as j_mg_pcg
from gnnla_tpu.models.vcycle import setup_twogrid as j_twogrid
from gnnla_tpu.models.vcycle import vcycle as j_vcycle
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian
from gnnla_tpu_torch.models.vcycle import setup_twogrid as t_twogrid
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.problems import laplacian_2d as t_laplacian

import test_torch_parallel_worker as W

WORLDS = (2, 4)
SUITE = "core"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds of gloo ranks, started at once; (run dir, {S: error or
    None})."""
    run_dir = str(tmp_path_factory.mktemp("parallel_core"))
    ctxs = {S: W.start(SUITE, S, run_dir) for S in WORLDS}
    return run_dir, {S: W.join(ctx, 120) for S, ctx in ctxs.items()}


def res(ranks, S, case, rank=0):
    return W.result(ranks[0], SUITE, S, case, rank)


def jmesh(S):
    return Mesh(np.array(jax.devices()[:S]), axis_names=("rows",))


def f32(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def j_put(x, part, mesh):
    return jpar.device_put_sharded(jpar.shard_vector(f32(x), part), mesh)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def j_scrambled(n=16, seed=3):
    Ah, _ = W.scrambled_laplacian(n, seed)
    return JSparse.from_scipy(Ah), Ah


# ------------------------------------------------------------- the ranks
@pytest.mark.parametrize("S", WORLDS)
def test_ranks_ran_every_case_alike(ranks, S):
    """Every rank ended well, and all ranks hold the same gathered
    results."""
    assert ranks[1][S] is None, ranks[1][S]
    for case in ("matvec", "vcycles", "mg_pcg", "stencil"):
        r0 = res(ranks, S, case)
        for r in range(1, S):
            other = res(ranks, S, case, r)
            for k, v in r0.items():
                if k != "seconds":
                    np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_public_names_have_twins():
    for name in jpar.__all__:
        assert name in tpar.__all__ and hasattr(tpar, name), name


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("S", (2, 4, 8))
def test_partition_bitwise(S):
    """partition_rows on a banded, a non-divisible and a scrambled
    (all-gather) operator, and partition_rows_rect of a two-grid P: every
    array and count bitwise JAX's."""
    js, Ah = j_scrambled()
    cases = [(j_laplacian(16), t_laplacian(16, device="cpu")),
             (j_laplacian(5), t_laplacian(5, device="cpu")),
             (js, TSparse.from_scipy(Ah, device="cpu"))]
    for jop, top in cases:
        pj, pt = jpar.partition_rows(jop, S), tpar.partition_rows(top, S)
        for f in ("rows_local", "cols_ext", "cols_global", "vals", "mask"):
            a, b = np.asarray(getattr(pj, f)), getattr(pt, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        for f in ("n_rows", "n_rows_padded", "rows_per_shard", "n_shards",
                  "halo", "halo_reach", "edges_per_shard"):
            assert getattr(pt, f) == getattr(pj, f), f
        x = np.arange(jop.n_rows, dtype=np.float32)
        xs = tpar.shard_vector(x, pt)
        np.testing.assert_array_equal(
            xs, np.asarray(jpar.shard_vector(f32(x), pj)))
        np.testing.assert_array_equal(tpar.unshard_vector(xs, pt), x)

    sj = j_twogrid(j_laplacian(16), theta=0.25, splitting="cljp", seed=0)
    st = t_twogrid(t_laplacian(16, device="cpu"), theta=0.25,
                   splitting="cljp", seed=0)
    rps = jpar.partition_rows(sj.A, S).rows_per_shard
    rj = jpar.partition_rows_rect(sj.P, S, rps)
    rt = tpar.partition_rows_rect(st.P, S, rps)
    for f in ("rows_local", "cols_global", "vals", "mask"):
        np.testing.assert_array_equal(getattr(rt, f),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert (rt.n_cols, rt.rows_per_shard) == (rj.n_cols, rj.rows_per_shard)


# ---------------------------------------------------------- collectives
@pytest.mark.parametrize("S", WORLDS)
def test_collectives_follow_jax(ranks, S):
    """ring_shift is ppermute (both ways, the identity for a full turn),
    its backward shifts the cotangent back; psum, pmax and the tiled
    all-gather; axis_index/size; to_global/replicate_global; the mesh
    helpers and grid_mesh's refusal."""
    xs = np.stack([np.arange(3.0) + 10 * i for i in range(S)]).astype(
        np.float32)
    mesh = jmesh(S)

    def ppermute(offset):
        fn = shard_map(lambda x: jax.lax.ppermute(
            x, "rows", [(i, (i + offset) % S) for i in range(S)]),
            mesh=mesh, in_specs=P("rows"), out_specs=P("rows"))
        return np.asarray(fn(jnp.asarray(xs)))

    right, left = ppermute(1), ppermute(-1)
    gathered = np.asarray(shard_map(
        lambda x: jax.lax.all_gather(x[0], "rows", tiled=True)[None],
        mesh=mesh, in_specs=P("rows"), out_specs=P("rows"))(
            jnp.asarray(xs)))
    ws = np.stack([np.arange(3.0) * (i + 1) for i in range(S)])
    for r in range(S):
        got = res(ranks, S, "collectives", r)
        assert int(got["index"]) == r and int(got["size"]) == S
        np.testing.assert_array_equal(got["right"], right[r])
        np.testing.assert_array_equal(got["left"], left[r])
        np.testing.assert_array_equal(got["full"], xs[r])
        # d/dx_r sum_q w_q . x_{q-1} = w_{r+1}
        np.testing.assert_array_equal(got["grad"], ws[(r + 1) % S])
        np.testing.assert_array_equal(got["psum"], xs.sum(0))
        np.testing.assert_array_equal(got["pmax"], xs.max(0))
        np.testing.assert_array_equal(got["gather"], gathered[r])
        np.testing.assert_array_equal(got["to_global"], [2 * r, 2 * r + 1])
        assert got["to_global_scalar"].item() == 5.0
        np.testing.assert_array_equal(got["replicate"],
                                      np.arange(2 * S).reshape(S, 2))
        assert list(got["row_mesh"]) == [S]
        assert list(got["grid_mesh"]) == [2, S // 2]
        assert list(got["grid_names"]) == ["data", "rows"]
        assert str(got["bad_grid"]).startswith("ValueError: mesh shape")


# ----------------------------------------------------------- COO SpMV
@pytest.mark.parametrize("S", WORLDS)
def test_sharded_matvec_matches(ranks, S):
    """rtol 1e-5, atol 1e-5 (test_parallel.py) against JAX's sharded
    matvec and A @ x: laplacian_2d(16), the non-divisible 5 x 5, and a
    scrambled Laplacian whose reach takes the all-gather path at S = 4."""
    got = res(ranks, S, "matvec")
    mesh = jmesh(S)
    for key, A in (("A16", j_laplacian(16)), ("A5", j_laplacian(5)),
                   ("scrambled", j_scrambled()[0])):
        part = jpar.partition_rows(A, S)
        x = np.random.default_rng(24601).random(A.n_rows)
        want = jpar.unshard_vector(jpar.make_sharded_matvec(part, mesh)(
            j_put(x, part, mesh)), part)
        close(got[key], want, 1e-5, 1e-5)
        close(got[key], A.matvec(f32(x)), 1e-5, 1e-5)
        if key == "scrambled":
            assert int(got["scrambled_reach"]) == part.halo_reach
            assert part.halo_reach > 1 or S == 2


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_jacobi_norm_power_match(ranks, S):
    """10 Jacobi sweeps at omega 0.7 (rtol 1e-4, atol 1e-4), the psum
    norm (rtol 1e-5) and 30 power iterations (lambda rtol 1e-4) against
    JAX's sharded functions and the single-device ones."""
    got = res(ranks, S, "jacobi_norm_power")
    A, mesh = j_laplacian(16), jmesh(S)
    part = jpar.partition_rows(A, S)
    rng = np.random.default_rng(24601)
    b, x0 = f32(rng.random(256)), f32(rng.random(256))
    bs, xs = j_put(b, part, mesh), j_put(x0, part, mesh)
    ds = j_put(A.diagonal(), part, mesh)
    want = jpar.unshard_vector(jpar.make_sharded_jacobi(part, mesh)(
        bs, xs, ds, 0.7, 10), part)
    close(got["jacobi"], want, 1e-4, 1e-4)
    close(got["jacobi"], j_jacobi(A, b, x0, omega=0.7, n_iters=10), 1e-4,
          1e-4)
    close(got["norm"], jpar.make_sharded_norm(part, mesh)(xs), 1e-5, 0)
    close(got["norm"], np.linalg.norm(np.asarray(x0)), 1e-5, 0)
    lam, bj = jpar.make_sharded_power_method(part, mesh)(xs, 30)
    close(got["lam"], lam, 1e-4, 0)
    close(got["lam"], j_power(A, x0, n_iters=30)[0], 1e-4, 0)
    close(got["power_b"], jpar.unshard_vector(bj, part), 1e-4, 1e-5)


# -------------------------------------------------------------- cycles
@pytest.fixture(scope="module")
def j_setups():
    return dict(
        twogrid=j_twogrid(j_laplacian(16), theta=0.25, splitting="cljp",
                          seed=0),
        sa48=j_sa(j_laplacian(48), min_coarse=16),
        sa32=j_sa(j_laplacian(32), min_coarse=16))


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_vcycle_matches_single_device(ranks, S, j_setups):
    """One two-grid cycle (n_pre = n_post = 2, degree 3) within rtol
    1e-4, atol 1e-5 of JAX's sharded cycle and the single-device vcycle;
    three chained within rtol 1e-3, atol 1e-4; the DIA setup refused."""
    got = res(ranks, S, "vcycles")
    setup, mesh = j_setups["twogrid"], jmesh(S)
    rng = np.random.default_rng(24601)
    b, x0 = f32(rng.random(256)), f32(rng.random(256))
    cycle, part = jpar.make_sharded_vcycle(setup, mesh, n_pre=2, n_post=2,
                                           coarse_deg=3)
    x_sh = cycle(j_put(b, part, mesh), j_put(x0, part, mesh))
    close(got["twogrid_0"], jpar.unshard_vector(x_sh, part), 1e-4, 1e-5)
    x_ref = x0
    for k in range(3):
        x_ref = j_vcycle(setup, b, x_ref, n_pre=2, n_post=2, coarse_deg=3)
        if k == 0:
            close(got["twogrid_0"], x_ref, 1e-4, 1e-5)
    close(got["twogrid_2"], x_ref, 1e-3, 1e-4)
    assert str(got["twogrid_guard"]).startswith(
        "ValueError: make_sharded_vcycle needs a COO")


@pytest.mark.parametrize("gamma", [1, 2])
@pytest.mark.parametrize("S", WORLDS)
def test_sharded_multigrid_cycle_matches_single_device(ranks, S, gamma,
                                                       j_setups):
    """2 sharded levels + the replicated tail of the 48^2 SA hierarchy:
    one cycle within rtol 1e-4, atol 1e-5 of JAX's sharded cycle and the
    single-device multigrid_cycle; three chained within rtol 1e-3, atol
    1e-4."""
    got = res(ranks, S, "vcycles")
    setup, mesh = j_setups["sa48"], jmesh(S)
    rng = np.random.default_rng(24601)
    b, x0 = f32(rng.random(2304)), f32(rng.random(2304))
    kw = dict(n_pre=2, n_post=2, coarse_deg=4, gamma=gamma)
    cycle, part = jpar.make_sharded_multigrid_cycle(
        setup, mesh, n_sharded_levels=2, **kw)
    x_sh = cycle(j_put(b, part, mesh), j_put(x0, part, mesh))
    close(got[f"mg{gamma}_0"], jpar.unshard_vector(x_sh, part), 1e-4, 1e-5)
    x_ref = x0
    for k in range(3):
        x_ref = j_mg_cycle(setup, b, x_ref, **kw)
        if k == 0:
            close(got[f"mg{gamma}_0"], x_ref, 1e-4, 1e-5)
    close(got[f"mg{gamma}_2"], x_ref, 1e-3, 1e-4)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_multigrid_cycle_auto_depth_and_guards(ranks, S, j_setups):
    """Automatic depth (the finest level only at 32^2): 4 cycles within
    rtol 1e-3, atol 1e-4 of multigrid_solve; the DIA hierarchy refused
    with JAX's message."""
    got = res(ranks, S, "vcycles")
    setup = j_setups["sa32"]
    b = f32(np.random.default_rng(7).random(1024))
    x_ref = j_mg_solve(setup, b, jnp.zeros(1024), n_cycles=4, n_pre=1,
                       n_post=1, coarse_deg=4)
    close(got["auto"], x_ref, 1e-3, 1e-4)
    assert "COO operators" in str(got["auto_guard"])
    assert str(got["auto_guard"]).startswith("ValueError")


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_mg_pcg_matches_and_converges(ranks, S, j_setups):
    """10 iterations of sharded mg_pcg (flip_sign, 2 sharded levels): x
    within rtol 1e-3, atol 1e-4 and the history within rtol 1e-2, atol
    1e-5 of JAX's sharded and single-device mg_pcg; 5 orders down."""
    got = res(ranks, S, "mg_pcg")
    setup, mesh = j_setups["sa48"], jmesh(S)
    b = f32(np.random.default_rng(24601).random(2304))
    x0 = jnp.zeros(2304, jnp.float32)
    solve, part = jpar.make_sharded_mg_pcg(setup, mesh, flip_sign=True,
                                           n_sharded_levels=2)
    x_sh, hist = solve(j_put(b, part, mesh), j_put(x0, part, mesh), 10)
    x_ref, hist_ref = j_mg_pcg(setup, b, x0, n_iters=10, flip_sign=True)
    for x_w, h_w in ((jpar.unshard_vector(x_sh, part), hist),
                     (x_ref, hist_ref)):
        close(got["x"], x_w, 1e-3, 1e-4)
        close(got["hist"], h_w, 1e-2, 1e-5)
    assert got["hist"][-1] < 1e-5 * float(jnp.linalg.norm(b))


# ------------------------------------------------------------- stencil
def _j_stencil(n, periodic=False):
    from gnnla_tpu.ops.pallas_stencil import stencil_taps
    from gnnla_tpu.problems.laplacian import laplacian_nd

    A = laplacian_nd([n, n], bcs=[1, 1])[0] if periodic else j_laplacian(n)
    shifts, planes = stencil_taps(A, (n, n))
    return A, shifts, jnp.asarray(planes.reshape(-1, n, n), jnp.float32)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stencil_matvec_parity(ranks, S, periodic):
    """Dirichlet and periodic 32^2: within rtol 1e-6, atol 1e-6 of JAX's
    sharded stencil matvec and the roll stencil, rtol 1e-5 of the COO
    matvec."""
    from gnnla_tpu.ops.pallas_stencil import stencil_matvec_jnp

    got = res(ranks, S, "stencil")[f"matvec_{int(periodic)}"]
    A, shifts, planes = _j_stencil(32, periodic)
    mesh = jmesh(S)
    x = f32(np.random.default_rng(0).standard_normal((32, 32)))
    y_sh = jpar.make_sharded_stencil_matvec(shifts, (32, 32), mesh)(
        jpar.shard_planes(planes, mesh), jpar.shard_vec2d(x, mesh))
    close(got, y_sh, 1e-6, 1e-6)
    close(got, stencil_matvec_jnp(planes, shifts, x), 1e-6, 1e-6)
    close(got.ravel(), A.matvec(x.ravel()), 1e-5, 1e-5)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stencil_probe_block_and_jacobi(ranks, S):
    """An [H, W, 3] probe block (rtol 1e-6, atol 1e-6 of the JAX sharded
    and roll stencils) and 5 sharded stencil Jacobi sweeps (rtol 1e-5,
    atol 1e-6 of JAX's sharded sweeps and models.jacobi)."""
    from gnnla_tpu.ops.pallas_stencil import stencil_matvec_jnp

    got = res(ranks, S, "stencil")
    mesh = jmesh(S)
    _, shifts, planes = _j_stencil(16)
    x = f32(np.random.default_rng(1).standard_normal((16, 16, 3)))
    y_sh = jpar.make_sharded_stencil_matvec(shifts, (16, 16), mesh)(
        jpar.shard_planes(planes, mesh), jpar.shard_vec2d(x, mesh))
    close(got["probe"], y_sh, 1e-6, 1e-6)
    close(got["probe"], stencil_matvec_jnp(planes, shifts, x), 1e-6, 1e-6)

    A, shifts, planes = _j_stencil(32)
    b = f32(np.random.default_rng(2).standard_normal((32, 32)))
    x0 = jnp.zeros((32, 32), jnp.float32)
    d2 = jnp.asarray(np.asarray(A.diagonal()).reshape(32, 32))
    x_sh = jpar.make_sharded_stencil_jacobi(shifts, (32, 32), mesh)(
        jpar.shard_planes(planes, mesh), jpar.shard_vec2d(d2, mesh),
        jpar.shard_vec2d(b, mesh), jpar.shard_vec2d(x0, mesh), 0.7, 5)
    close(got["jacobi"], x_sh, 1e-5, 1e-6)
    close(got["jacobi"].ravel(), j_jacobi(A, b.ravel(), x0.ravel(),
                                          omega=0.7, n_iters=5), 1e-5, 1e-6)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_stencil_rejects_bad_grid(ranks, S):
    """A grid height the ranks do not divide, and a row reach beyond one
    shard: ValueError in both packages, with JAX's messages."""
    got = res(ranks, S, "stencil")
    mesh = jmesh(S)
    _, shifts, _ = _j_stencil(16)
    bad = 4 * S + 1
    with pytest.raises(ValueError, match="not divisible"):
        jpar.make_sharded_stencil_matvec(shifts, (bad, bad), mesh)
    assert str(got["bad_grid"]).startswith("ValueError: grid H=")
    assert "not divisible" in str(got["bad_grid"])
    # one-row shards and a row shift of 2: a reach of 2 from S = 4 on (at
    # S = 2 the shift wraps to 0 in both)
    if S >= 4:
        with pytest.raises(ValueError, match="exceeds"):
            jpar.make_sharded_stencil_matvec([(0, 0), (2, 0)], (S, 8), mesh)
        assert str(got["bad_reach"]).startswith(
            "ValueError: stencil row reach")
    else:
        jpar.make_sharded_stencil_matvec([(0, 0), (2, 0)], (S, 8), mesh)
        assert str(got["bad_reach"]) == ""


def test_stencil_scaling_model():
    """With the JAX package's constants the port's model gives JAX's dict
    exactly; with its own (the H100's spec sheet) the modeled efficiency
    exceeds 0.8 at 2048^2 on 8 devices and falls with the device count."""
    from gnnla_tpu.parallel.stencil import HBM_BW, ICI_BW

    for args in ((2048, 2048, 9, 8), (512, 512, 9, 1), (96, 64, 5, 4)):
        want = jpar.stencil_scaling_model(*args)
        got = tpar.stencil_scaling_model(*args, hbm_bw=HBM_BW,
                                         link_bw=ICI_BW)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    m = tpar.stencil_scaling_model(2048, 2048, 9, 8)
    assert m["efficiency_serial"] > 0.8
    assert m["efficiency_overlapped"] >= m["efficiency_serial"]
    effs = [tpar.stencil_scaling_model(512, 512, 9, d)["efficiency_serial"]
            for d in (1, 2, 4, 8, 16)]
    assert all(a >= b for a, b in zip(effs, effs[1:]))
    assert m["comm_bytes_per_chip"] == 2 * 1 * 2048 * 4
