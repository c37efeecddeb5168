"""Programs (`gnnla_tpu_torch/utils/program.py`, the port's twin of
`jax.jit`) on the CPU: every entry point the port routes through a
program against its jitted or scanned JAX twin, the program bodies free of
host synchronisation, and the launch recorder and layout guards as plain
Python.

On the CPU a program is its function, so these tests hold what a program
runs; the capture and the replay themselves run only on the card
(`tests/test_torch_gpu.py`, marked `gpu`). The JAX side runs jitted, with
kernel K4 in Pallas interpret mode and the stream kernel on its emulator;
the port runs its kernels' plain versions on CPU tensors. Inputs are
numpy-seeded and identical on both sides; every operator is built by the
JAX package and carried across as COO triplets, or built by each package
from the same problem (asserted identical in the other test files).

Tolerance: the port's fast-path one, rtol 2e-5, atol 2e-5 * max|y|
(`tests/test_torch_vcycle.py`): the two sides sum in different orders in
f32.
"""

import contextlib
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import __graft_entry__ as jax_entry
from gnnla_tpu.models.geometric import GeometricVCycle as JGeometric
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu.problems import laplacian_nd
from gnnla_tpu_torch import graft_entry
from gnnla_tpu_torch.models.geometric import GeometricVCycle
from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.problems import laplacian_2d as t_laplacian_2d
from gnnla_tpu_torch.utils.program import Program, count, guard, program

jv = importlib.import_module("gnnla_tpu.models.vcycle")
tv = importlib.import_module("gnnla_tpu_torch.models.vcycle")
jm = importlib.import_module("gnnla_tpu.models.multigrid")
tm = importlib.import_module("gnnla_tpu_torch.models.multigrid")
jk = importlib.import_module("gnnla_tpu.models.krylov")
tk = importlib.import_module("gnnla_tpu_torch.models.krylov")
prog = importlib.import_module("gnnla_tpu_torch.utils.program")

CPU = "cpu"
N = 32  # the grid side
RTOL = 2e-5
N_CYCLES = 3


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def carry(op_j):
    rows, cols, vals = op_j.host_coo()
    return TSparse.from_coo(rows, cols, vals, op_j.shape, device=CPU)


def export(s_j):
    """A JAX TwoGridSetup as plain numpy arrays (setup_from_numpy keys)."""
    d = {"diag": np.asarray(s_j.diag),
         "coarse_flags": np.asarray(s_j.coarse_flags)}
    for name in ("A", "P", "Ac"):
        op = getattr(s_j, name)
        d[f"{name}_rows"], d[f"{name}_cols"], d[f"{name}_vals"] = \
            op.host_coo()
        d[f"{name}_shape"] = np.asarray(op.shape)
    return d


@functools.lru_cache(maxsize=None)
def twogrid(splitting="cljp"):
    """(JAX setup, port setup carried across) of the 32^2 Laplacian."""
    A_j = j_laplacian_2d(N).eliminate_zeros()
    s_j = jv.setup_twogrid(A_j, theta=0.25, splitting=splitting, seed=0)
    return s_j, tv.setup_from_numpy(export(s_j), device=CPU)


def chained(run, b, x, n):
    for _ in range(n):
        x = run(b, x)
    return x


def pair(n, seed):
    b = vec(n, seed)
    x = vec(n, seed + 1)
    return (jnp.asarray(b), jnp.asarray(x)), (torch.from_numpy(b),
                                             torch.from_numpy(x))


# --------------------------------------------------- the program on the CPU
def test_program_on_cpu_is_the_function_bitwise():
    """On CPU tensors a program returns its function's output bit for bit
    (it calls it), captures nothing, and keeps static arguments static."""
    _, s_t = twogrid()
    (_, _), (b, x) = pair(N * N, 0)
    run = program(tv.solve)
    got = run(s_t, b, x, n_cycles=N_CYCLES)
    want = tv.solve(s_t, b, x, n_cycles=N_CYCLES)
    assert torch.equal(got, want)
    assert run.captures == run.replays == 0
    assert isinstance(run, Program) and run.fn is tv.solve


def test_program_refuses_no_tensor_and_two_devices():
    run = program(lambda a, b=None: a)
    with pytest.raises(ValueError, match="tensor input"):
        run(3.0)
    with pytest.raises(ValueError, match="one device"):
        program(lambda a, b: a)(torch.ones(2), torch.ones(2, device="meta"))


def test_static_keys():
    """Values key scalars and tuples of them; everything else its
    identity: a new setup object, even an equal one, is a new key (one
    capture each on the card)."""
    s = object()
    assert prog._static_key(3) == prog._static_key(3)
    assert prog._static_key(3) != prog._static_key(3.0)
    assert prog._static_key((16, 16)) == prog._static_key((16, 16))
    assert prog._static_key(s) == ("id", id(s))
    assert prog._static_key(torch.float32) == (torch.dtype, torch.float32)
    _, s_t = twogrid()
    assert prog._static_key(dataclasses.replace(s_t)) != \
        prog._static_key(s_t)


# -------------------------------------------- entry points against JAX's
def test_stencil_vcycle_run_matches_jax():
    """`StencilVCycle.run` (the JAX `_jit_cycle`), one cycle and three
    chained, on the CLJP setup."""
    s_j, s_t = twogrid()
    sv_j = jv.make_stencil_vcycle(s_j, (N, N))
    sv_t = tv.make_stencil_vcycle(s_t, (N, N))
    assert isinstance(sv_t.program, Program) and sv_t.program.fn == \
        sv_t.cycle
    (bj, xj), (bt, xt) = pair(N * N, 1)
    assert_close(sv_t.run(bt, xt), sv_j.run(bj, xj))
    assert_close(chained(sv_t.run, bt, xt, N_CYCLES),
                 chained(sv_j.run, bj, xj, N_CYCLES))
    assert torch.equal(sv_t.run(bt, xt), sv_t.cycle(bt, xt))


def test_geometric_vcycle_run_matches_jax():
    """`GeometricVCycle.run` (the JAX `_jit_cycle`) on the alternating
    setup, one cycle and three chained."""
    s_j, s_t = twogrid("alternating")
    g_j = JGeometric(s_j.A, (N, N), setup=s_j)
    g_t = GeometricVCycle(s_t.A, (N, N), setup=s_t)
    assert g_t.program.fn == g_t.cycle
    (bj, xj), (bt, xt) = pair(N * N, 2)
    assert_close(g_t.run(bt, xt), g_j.run(bj, xj))
    assert_close(chained(g_t.run, bt, xt, N_CYCLES),
                 chained(g_j.run, bj, xj, N_CYCLES))


def permuted_grid(h=70, w=60, seed=0):
    """A shuffled 5-point Laplacian (4200 rows): the stream layout."""
    def lap1d(m):
        return sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], (m, m))

    A = sp.kron(sp.eye(h), lap1d(w)) + sp.kron(lap1d(h), sp.eye(w))
    p = np.random.default_rng(seed).permutation(h * w)
    A = A.tocsr()[p][:, p].tocoo()
    return JSparse.from_coo(A.row, A.col, A.data, A.shape)


def random_graph(n=600, seed=3):
    R = sp.random(n, n, density=0.02, random_state=seed, format="csr")
    A = (R + R.T + 20 * sp.eye(n)).tocoo()
    return JSparse.from_coo(A.row, A.col, A.data, A.shape)


LAYOUTS = {"stencil": lambda: j_laplacian_2d(N).eliminate_zeros(),
           "dia": lambda: laplacian_nd((37 * 41,))[0].eliminate_zeros(),
           "stream": permuted_grid,
           "coo": random_graph}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_auto_two_grid_run_and_solve_match_jax(layout):
    """`AutoTwoGrid.run` (the JAX `_run`) and `.solve` (a jitted `solve`;
    a loop of `run`s on the stencil layout) on each layout it takes."""
    A_j = LAYOUTS[layout]()
    auto_j = jv.setup_auto(A_j, seed=0, stream_backend="emulate")
    auto_t = tv.setup_auto(carry(A_j), seed=0)
    assert auto_t.layout == auto_j.layout == layout
    (bj, xj), (bt, xt) = pair(A_j.n_rows, 3)
    assert_close(auto_t.run(bt, xt), auto_j.run(bj, xj))
    assert_close(auto_t.solve(bt, xt, n_cycles=N_CYCLES),
                 auto_j.solve(bj, xj, n_cycles=N_CYCLES))


@pytest.mark.parametrize("fast", [False, True], ids=["coo", "k1-k2"])
def test_solve_program_matches_jax_scan(fast):
    """`program(solve)` with n_cycles = 3 against the JAX `lax.scan`
    solve, jitted: on the COO setup, and with A, Ac on K1 and P on K2
    (their plain versions here) against the JAX DIA setup."""
    s_j, s_t = twogrid()
    if fast:
        s_j = jv.setup_with_dia(s_j)
        s_t = tv.setup_with_stream_p(tv.setup_with_dia(s_t, kernel=True))
        assert isinstance(s_t.A, DiaKernelOperator)
    (bj, xj), (bt, xt) = pair(N * N, 4)
    want = jax.jit(lambda s, b, x: jv.solve(s, b, x, n_cycles=N_CYCLES))(
        s_j, bj, xj)
    assert_close(program(tv.solve)(s_t, bt, xt, n_cycles=N_CYCLES), want)


@functools.lru_cache(maxsize=None)
def hierarchies():
    """The SA hierarchies of the 32^2 Laplacian, each package's own (the
    multigrid tests hold them identical); the port's banded levels on
    K1, the JAX package's on DIA."""
    s_j = jm.setup_with_dia_multigrid(
        jm.setup_sa_multigrid(j_laplacian_2d(N), seed=0))
    s_t = tm.setup_with_dia_multigrid(
        tm.setup_sa_multigrid(t_laplacian_2d(N, device=CPU), seed=0),
        kernel=True)
    return s_j, s_t


def test_multigrid_solve_program_matches_jax():
    s_j, s_t = hierarchies()
    (bj, xj), (bt, xt) = pair(N * N, 5)
    kw = dict(n_cycles=N_CYCLES, n_pre=2, n_post=2)
    want = jax.jit(lambda s, b, x: jm.multigrid_solve(s, b, x, **kw))(
        s_j, bj, xj)
    assert_close(program(tm.multigrid_solve)(s_t, bt, xt, **kw), want)


@pytest.mark.parametrize("solver", ["amg_pcg", "mg_pcg"])
def test_pcg_program_matches_jax(solver):
    """`program(amg_pcg)` on the two-grid setup and `program(mg_pcg)` on
    the SA hierarchy, 4 iterations, x and the residual history, against
    the jitted JAX solvers."""
    if solver == "amg_pcg":
        s_j, s_t = twogrid()
    else:
        s_j, s_t = hierarchies()
    (bj, _), (bt, _) = pair(N * N, 6)
    kw = dict(n_iters=4, flip_sign=True)
    fj, ft = getattr(jk, solver), getattr(tk, solver)
    x_j, h_j = jax.jit(lambda s, b, x: fj(s, b, x, **kw))(
        s_j, bj, jnp.zeros(N * N))
    x_t, h_t = program(ft)(s_t, bt, torch.zeros(N * N), **kw)
    assert_close(x_t, x_j)
    assert_close(h_t, h_j)


def test_flagship_program_matches_the_jax_entry():
    """`program(flagship_cycle)` against the JAX `entry()`'s fn, jitted,
    on their own inputs (bitwise equal: tests/test_torch_graft_entry.py)."""
    fn_j, args_j = jax_entry.entry()
    fn_t, args_t = graft_entry.entry(device=CPU)
    assert_close(program(fn_t)(*args_t), jax.jit(fn_j)(*args_j))


# ------------------------------------------ no host sync in the bodies
@contextlib.contextmanager
def no_host_sync():
    """Tensor.item, .tolist, .numpy and the bool, float and int
    conversions raise: what would synchronise with the card (and fail
    under capture) inside a program's body."""
    names = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(name):
        def f(*_args, **_kw):
            raise AssertionError(f"host sync in a program body: {name}")
        return f

    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def bodies():
    """(name, body, args, kwargs) of every function a program of the
    port runs, on their CPU setups."""
    s_cljp, s_alt = twogrid()[1], twogrid("alternating")[1]
    fast = tv.setup_with_stream_p(tv.setup_with_dia(s_cljp, kernel=True))
    _, mg = hierarchies()
    sv = tv.make_stencil_vcycle(s_cljp, (N, N))
    gv = GeometricVCycle(s_alt.A, (N, N), setup=s_alt)
    stream = tv.setup_auto(carry(permuted_grid()), seed=0)
    fn, entry_args = graft_entry.entry(device=CPU)
    b, x = torch.from_numpy(vec(N * N, 7)), torch.from_numpy(vec(N * N, 8))
    bs = torch.from_numpy(vec(stream.setup.A.n_rows, 9))
    return [
        ("StencilVCycle.cycle", sv.cycle, (b, x), {}),
        ("GeometricVCycle.cycle", gv.cycle, (b, x), {}),
        ("vcycle", tv.vcycle, (fast, b, x), {}),
        ("solve", tv.solve, (fast, b, x), dict(n_cycles=2)),
        ("solve[stream]", tv.solve, (stream.setup, bs, bs), dict(
            n_cycles=1)),
        ("multigrid_solve", tm.multigrid_solve, (mg, b, x), dict(
            n_cycles=1)),
        ("amg_pcg", tk.amg_pcg, (fast, b, x), dict(n_iters=2,
                                                   flip_sign=True)),
        ("mg_pcg", tk.mg_pcg, (mg, b, x), dict(n_iters=2, flip_sign=True)),
        ("flagship_cycle", fn, entry_args, {}),
    ]


def test_program_bodies_do_not_sync_with_the_host():
    """Each body runs with every host-sync method of Tensor refused. A
    partial check: on the CPU the kernels' plain versions run, not the
    wrappers' card path (the card tests capture those)."""
    cases = bodies()
    (stream_args,) = [c[2] for c in cases if c[0] == "solve[stream]"]
    assert type(stream_args[0].A).__name__ == "StreamOperator"
    for name, fn, args, kw in cases:
        with no_host_sync():
            out = fn(*args, **kw)
        assert all(bool(torch.isfinite(t).all())
                   for t in (out if isinstance(out, tuple) else (out,))), \
            name


def test_no_host_sync_refuses():
    with no_host_sync():
        with pytest.raises(AssertionError, match="item"):
            torch.ones(1).item()
        with pytest.raises(AssertionError, match="__bool__"):
            bool(torch.ones(1) > 0)
    assert torch.ones(1).item() == 1.0


# ---------------------------------------------- the recorder and guards
class Counted:
    def __init__(self):
        self.launches = 0
        self.launches_t = 0


def test_count_outside_a_capture_adds_now():
    c = Counted()
    count(c, "launches")
    count(c, "launches_t", 3)
    assert (c.launches, c.launches_t) == (1, 3)


def test_a_recorded_capture_moves_nothing_and_each_replay_adds_it():
    """Within a recording nothing moves; each application adds what was
    recorded, so N replays read N times the per-call count."""
    c, d = Counted(), Counted()
    rec = prog._Record()
    with prog._recording(rec):
        count(c, "launches", 3)
        count(c, "launches")
        count(d, "launches_t", 7)
    assert (c.launches, c.launches_t, d.launches_t) == (0, 0, 0)
    for _ in range(5):
        rec.apply()
    assert (c.launches, c.launches_t, d.launches_t) == (5 * 4, 0, 5 * 7)
    count(c, "launches")  # outside: immediate again
    assert c.launches == 21


def test_the_k1_guard_asks_for_a_new_capture_after_an_update():
    """K1's layouts register their key while recorded; a bumped
    `_version` (an in-place update of the diagonals) makes the guard
    fail, and the next eager call rebuilds the layout (`rebuilds`)."""
    _, s_t = twogrid()
    op = tv.setup_with_dia(s_t, kernel=True).A
    assert isinstance(op, DiaKernelOperator)
    rec = prog._Record()
    with prog._recording(rec):
        op.layouts()
        op.layouts()
    assert list(rec.guards) == [op._layout_key] and rec.holds()
    assert op.rebuilds == 0
    with torch.no_grad():
        op.diags.mul_(1.0)
    assert not rec.holds()
    op.layouts()
    assert op.rebuilds == 1
    assert not rec.holds()  # the old capture's key stays stale


def test_guards_register_only_inside_a_capture_once_each():
    def read():
        return 1

    rec = prog._Record()
    guard(read, 2)  # outside a capture: nothing
    with prog._recording(rec):
        guard(read, 3)
        guard(read, 4)  # the key at the first registration stays
    assert rec.guards == {read: 3} and not rec.holds()
    assert prog._CAPTURE.get() is None and not prog._INSIDE.get()


def test_k1_k2_k4_count_through_the_recorder(monkeypatch):
    """The K1, K2/K3 and K4 wrappers count through `count` (so a capture
    records them), K2 its nonzeros into `K2_TALLY` too: their card paths,
    with the launches stubbed out."""
    from gnnla_tpu_torch.ops import dia_spmv, stencil_kernel, stream_spmv

    seen = []
    monkeypatch.setattr(dia_spmv, "count",
                        lambda o, a, k=1: seen.append((type(o).__name__, a,
                                                       k)))
    monkeypatch.setattr(stream_spmv, "count",
                        lambda o, a, k=1: seen.append((type(o).__name__, a,
                                                       k)))
    monkeypatch.setattr(stencil_kernel, "count",
                        lambda o, a, k=1: seen.append((type(o).__name__, a,
                                                       k)))
    monkeypatch.setattr(dia_spmv, "dia_tiles_spmv_cuda", lambda t, x: x)
    monkeypatch.setattr(stream_spmv, "csr_spmv_cuda", lambda *a: a[3])
    monkeypatch.setattr(stencil_kernel, "stencil_cuda", lambda *a: a[2])
    meta = torch.empty(N * N, device="meta")
    _, s_t = twogrid()
    fast = tv.setup_with_stream_p(tv.setup_with_dia(s_t, kernel=True))
    fast.A.launch(meta)
    fast.A.launch_t(meta)
    fast.P.fwd.launch(torch.empty(fast.P.shape[1], device="meta"),
                      fast.P.fwd.vals)
    fast.P.fwd.launch(torch.empty(fast.P.shape[1], 4, device="meta"),
                      fast.P.fwd.vals)
    call = tv.make_stencil_vcycle(s_t, (N, N))._pre._call
    call(meta.reshape(N, N), meta.reshape(N, N))
    assert seen == [("DiaKernelOperator", "launches", 1),
                    ("DiaKernelOperator", "launches", 1),
                    ("CsrSpMV", "launches", 1),
                    ("SimpleNamespace", "nnz", fast.P.fwd.nnz),
                    ("SimpleNamespace", "warp_nnz", fast.P.fwd.warp_nnz),
                    ("CsrSpMV", "launches_mm", 1),
                    ("StencilCall", "launches", stencil_kernel.
                     stencil_launches("affine", 3, call.form.form))]


# -------------------------------------------------------------- lifetime
class Static:
    """A static argument: an object keyed by its identity."""


def _kept(p, *statics):
    """A stand-in graph cached by `p` under the statics' key, as a capture
    caches it (the graph itself exists only on the card)."""
    key = (False, tuple(prog._static_key(a) for a in statics), ())
    g = prog._Graph(None, [], None, prog._Record())
    p._keep(key, g, prog._objects(list(statics)))
    return key, g


def test_static_objects_are_those_keyed_by_identity():
    a, b, t = Static(), Static(), torch.zeros(2)
    got = prog._objects([a, (1, b, [t, "x", None]), 2.0, torch.float32])
    assert [id(o) for o in got] == [id(a), id(b), id(t)]


def test_a_collected_static_releases_its_graphs():
    """Graphs are held while their statics live: the plain and the traced
    key of one object both leave when it is collected, another object's
    graph stays, and `live` counts the rest."""
    p = Program(lambda *a: None)
    a, b = Static(), Static()
    key_a, _ = _kept(p, a)
    p._keep((True,) + key_a[1:], prog._Graph(None, [], None, prog._Record()),
            [a])
    key_b, g_b = _kept(p, b)
    assert (p.live, p.released) == (3, 0) and g_b.held == []
    del a
    assert (p.live, p.released) == (1, 2)
    assert list(p._graphs) == [key_b] and p._dead == []


def test_a_new_object_with_a_dead_ones_id_finds_no_graph():
    p = Program(lambda *a: None)
    a = Static()
    dead_id = id(a)
    key, _ = _kept(p, a)
    del a
    made = []   # kept, so that each new object takes a new block
    while len(made) < 10000 and (not made or id(made[-1]) != dead_id):
        made.append(Static())
    b = made[-1]
    assert id(b) == dead_id   # CPython handed the freed block out again
    assert (False, (prog._static_key(b),), ()) == key
    assert key not in p._graphs and p.released == 1


def test_a_static_that_cannot_be_weakly_referenced_is_held():
    p = Program(lambda *a: None)
    d = {"n": 1}
    _, g = _kept(p, d, Static())
    assert g.held == [d] and len(g.watch) == 1


def test_a_graph_replaced_under_its_key_is_not_released_twice():
    p = Program(lambda *a: None)
    a = Static()
    key, _ = _kept(p, a)
    key2, g2 = _kept(p, a)   # a recapture: the same key, a new graph
    assert key2 == key and p._graphs[key] is g2 and p.live == 1
    del a
    assert (p.live, p.released) == (0, 1)


def test_a_release_inside_a_capture_waits_for_the_next_call():
    """Destroying a graph while a stream captures invalidates the capture:
    a graph released inside one is kept aside (out of the cache) until
    the program's next call."""
    p = Program(lambda *a: None)
    a = Static()
    key, g = _kept(p, a)
    with prog._recording(prog._Record()):
        del a
    assert key not in p._graphs and p._dead == [g] and p.released == 1
    del g


def test_a_solved_hierarchy_dies_with_its_last_reference():
    """After a solve the SA hierarchy holds no reference cycle: dropping
    the caller's reference frees it at once, with the cyclic collector
    off, so a program releases its graph then and not at a later
    collection."""
    import gc
    import weakref

    A = t_laplacian_2d(N, device=CPU).eliminate_zeros()
    mg = tm.setup_with_dia_multigrid(tm.setup_sa_multigrid(A), kernel=True)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        N * N).astype(np.float32))
    refs = [weakref.ref(o) for o in (mg, *mg.As, *mg.Ps)]
    was = gc.isenabled()
    gc.disable()
    try:
        tk.mg_pcg(mg, b, torch.zeros_like(b), n_iters=3, flip_sign=True)
        tm.multigrid_solve(mg, b, torch.zeros_like(b), n_cycles=2, gamma=2)
        del mg
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()
