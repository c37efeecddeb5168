"""The port's entry contract (`gnnla_tpu_torch.graft_entry`) against the
JAX repository's `__graft_entry__.py` on the CPU.

`entry(device="cpu")` must rebuild the JAX `entry()`'s inputs bit for
bit: b and x, A's and Ac's DIA offsets and diagonals, P's COO triplets,
the Jacobi diagonal and the C/F flags. Its cycle is held against
`jax.jit(fn)` within rtol 2e-5, atol 2e-5 * max|y| (the port's fast-path
tolerance, tests/test_torch_vcycle.py); two f32 programs with their own
summation orders, measured 1.2e-7 of max|y| apart.

`dryrun_multichip` runs as one call with no process group: it spawns its
own gloo ranks (a few seconds each world), and a failing rank fails the
call. `spawn_ranks` is driven with the no-JAX helpers of
tests/test_torch_parallel_worker.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jax_entry
from gnnla_tpu.models import solve as j_solve
from gnnla_tpu.models import setup_twogrid as j_setup_twogrid
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu_torch import graft_entry
from gnnla_tpu_torch.models.vcycle import (setup_from_numpy, setup_with_dia,
                                           solve)
from gnnla_tpu_torch.ops.dia import DIAOperator
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.parallel.distributed import spawn_ranks

import test_torch_parallel_worker as W

CPU = "cpu"
RTOL = 2e-5
N_CHAINED = 5
LINE = re.compile(r"^entry\(\) vcycle output norm: (\S+)$", re.M)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_pair():
    fn, args = jax_entry.entry()
    return fn, args, np.asarray(jax.jit(fn)(*args))


@pytest.fixture(scope="module")
def port_pair():
    return graft_entry.entry(device=CPU)


def _field(setup, path):
    obj = setup
    for name in path.split("."):
        obj = getattr(obj, name)
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    return np.asarray(obj)


@pytest.mark.parametrize("i,name", [(1, "b"), (2, "x")])
def test_inputs_are_jax_bits(jax_pair, port_pair, i, name):
    want = np.asarray(jax_pair[1][i])
    got = port_pair[1][i]
    assert got.dtype == torch.float32 and got.shape == (256,)
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.view(np.uint32)), name


def test_operator_types(port_pair):
    """A and Ac on the plain DIA operator (the JAX entry's pallas=False),
    P in COO: the contract's path runs no hand-written kernel."""
    setup = port_pair[1][0]
    assert type(setup.A) is DIAOperator and type(setup.Ac) is DIAOperator
    assert type(setup.P) is SparseOperator
    assert setup.A.offsets == (-16, -1, 0, 1, 16)
    assert len(setup.Ac.offsets) == 27


@pytest.mark.parametrize("path", [
    "A.offsets", "A.diags", "Ac.offsets", "Ac.diags", "P.rows", "P.cols",
    "P.vals", "P.shape", "diag", "coarse_flags"])
def test_setup_arrays_are_jax_bits(jax_pair, port_pair, path):
    want = _field(jax_pair[1][0], path)
    got = _field(port_pair[1][0], path)
    assert got.shape == want.shape
    if got.dtype.kind == "f":
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    else:  # the port keeps its flags as int64, JAX as int32
        assert np.array_equal(got, want)


def test_cycle_matches_jax(jax_pair, port_pair):
    fn, args = port_pair
    y = fn(*args)
    assert y.shape == (256,) and y.dtype == torch.float32
    assert_close(y.numpy(), jax_pair[2])


def test_chained_cycles_match_jax_solve(jax_pair, port_pair):
    """Five chained `fn` calls against the JAX `solve` (lax.scan) of five
    cycles with the contract's parameters, from the entry's x."""
    _, (s_j, b_j, x_j), _ = jax_pair
    fn, (setup, b, x) = port_pair
    want = np.asarray(j_solve(s_j, b_j, x_j, n_cycles=N_CHAINED, n_pre=3,
                              n_post=3, coarse_deg=4))
    for _ in range(N_CHAINED):
        x = fn(setup, b, x)
    assert_close(x.numpy(), want)
    # the port's own `solve` gives the same cycles
    assert torch.equal(x, solve(setup, b, port_pair[1][2],
                                n_cycles=N_CHAINED, n_pre=3, n_post=3,
                                coarse_deg=4))


def test_setup_carried_across_from_jax(jax_pair, port_pair):
    """The JAX entry's setup (before its DIA swap) carried across as COO
    triplets with `setup_from_numpy`, then `setup_with_dia`: the same
    cycle output as the port's own setup, within the tolerance of JAX's."""
    s_j = j_setup_twogrid(j_laplacian_2d(16), theta=0.25, splitting="cljp",
                          seed=0)
    d = {"diag": np.asarray(s_j.diag),
         "coarse_flags": np.asarray(s_j.coarse_flags)}
    for name in ("A", "P", "Ac"):
        op = getattr(s_j, name)
        d.update({f"{name}_rows": np.asarray(op.rows),
                  f"{name}_cols": np.asarray(op.cols),
                  f"{name}_vals": np.asarray(op.vals),
                  f"{name}_shape": np.asarray(op.shape)})
    carried = setup_with_dia(setup_from_numpy(d, device=CPU))
    assert type(carried.A) is DIAOperator and type(carried.Ac) is DIAOperator
    fn, (_, b, x) = port_pair
    y = fn(carried, b, x)
    assert_close(y.numpy(), jax_pair[2])
    assert torch.equal(y, fn(*port_pair[1]))


def test_fn_writes_into_no_argument_and_repeats_bitwise(port_pair):
    fn, (setup, b, x) = port_pair
    tensors = {"b": b, "x": x, "diag": setup.diag,
               "coarse_flags": setup.coarse_flags,
               "A.diags": setup.A.diags, "Ac.diags": setup.Ac.diags,
               "P.vals": setup.P.vals}
    before = {k: t.clone() for k, t in tensors.items()}
    y1 = fn(setup, b, x)
    y2 = fn(setup, b, x)
    assert torch.equal(y1, y2)
    for k, t in tensors.items():
        assert torch.equal(t, before[k]), k
    assert y1.data_ptr() != x.data_ptr()


def test_main_prints_the_norm(jax_pair, capsys):
    assert graft_entry.main(["--device", CPU]) == 0
    m = LINE.search(capsys.readouterr().out)
    assert m, "no norm line"
    want = float(jnp.linalg.norm(jax_pair[2]))
    assert abs(float(m.group(1)) - want) <= RTOL * want


def test_module_runs_as_a_program():
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    p = subprocess.run([sys.executable, "-m", "gnnla_tpu_torch.graft_entry",
                        "--device", CPU], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    m = LINE.search(p.stdout)
    assert m and np.isfinite(float(m.group(1))), p.stdout


# ------------------------------------------------------------- dry run
@pytest.fixture(scope="module")
def spawned_dryrun():
    assert not dist.is_initialized()
    return graft_entry.dryrun_multichip(2, device=CPU)


def test_dryrun_spawns_two_gloo_ranks(spawned_dryrun):
    res = spawned_dryrun
    assert tuple(res["mesh"]) == (2, 1)
    assert res["backend"] == "gloo"
    assert res["line"].startswith("dryrun_multichip(2): ")
    assert not dist.is_initialized()  # the call left no group behind


@pytest.mark.parametrize("key", ["loss_rel_gap", "param_max_abs_gap"])
def test_dryrun_step_gaps(spawned_dryrun, key):
    assert spawned_dryrun[key] <= 1e-6


def test_dryrun_result_holds_no_rank_objects(spawned_dryrun):
    """Rank 0's results come back without the kernel objects that live in
    its process; its errors and K2 launches come back."""
    assert "stream_kernel" not in spawned_dryrun
    assert "stream_vcycle_kernel" not in spawned_dryrun
    assert spawned_dryrun["k2_launches"] == 0  # K2 launches on the card only
    for key in ("stencil_max_abs_err", "stream_max_abs_err",
                "stream_vcycle_max_abs_err"):
        assert np.isfinite(spawned_dryrun[key])


def test_dryrun_raises_when_its_ranks_fail():
    """Five ranks cannot split the step's 48 rows: every rank raises, and
    so does the call."""
    with pytest.raises(RuntimeError, match="do not split over 5 ranks"):
        graft_entry.dryrun_multichip(5, device=CPU)


def test_dryrun_delegates_inside_a_process_group(tmp_path):
    """Inside an initialized group the call runs on this rank: the
    world's size must match, and the full results come back."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="need 2 ranks, have 1"):
            graft_entry.dryrun_multichip(2, device=CPU)
        res = graft_entry.dryrun_multichip(1, device=CPU)
    finally:
        dist.destroy_process_group()
    assert tuple(res["mesh"]) == (1, 1)
    assert res["loss_rel_gap"] <= 1e-6 and res["param_max_abs_gap"] <= 1e-6
    assert "stream_kernel" in res


# -------------------------------------------------------- spawn_ranks
def test_spawn_ranks_returns_rank_0s_value():
    assert spawn_ranks(W.rank_or_raise, 2, (-1,), device=CPU) == 0


def test_spawn_ranks_raises_with_the_failing_rank_error():
    with pytest.raises(RuntimeError, match="rank 1 of 2 fails"):
        spawn_ranks(W.rank_or_raise, 2, (1,), device=CPU)


def test_spawn_ranks_kills_ranks_past_the_timeout():
    with pytest.raises(RuntimeError, match="timed out"):
        spawn_ranks(W.sleep_then_rank, 2, (60.0,), device=CPU, timeout=5.0)
