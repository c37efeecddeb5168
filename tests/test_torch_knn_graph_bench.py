"""The benchmark's general-graph deployment (`knn32_graph_1m.matvec`) on
the CPU at 4,096 points: its matrix (`perfbench/problems/knn_graph.py`)
against the bench twin's and the JAX bench's fixture, the port's
`stream_operator(reorder=True, transpose=False)` in the caller's order
against the float64 plain reference, the cell through the harness (the
program correct, the bfloat16 control not), the stages, spans and
counter the cell reads, and each new reader's arithmetic.

Tolerance on y = A x: max|y - A x| / max|A x| <= 1e-5. The port rounds
the values to float32 once (2^-24 = 6e-8 relative) and sums each row's
33 or so products in float32, in RCM order; it reads about 2e-7 here.
The reference computed in bfloat16 (2^-8 rounding) reads about 1.5e-2
and must fail it.
"""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bench as jax_bench
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stream_op import stream_operator
from gnnla_tpu_torch.ops.stream_spmv import rcm_csr
from gnnla_tpu_torch.scratch import bench_stream
from gnnla_tpu_torch.utils import program as prog
from perfbench import harness
from perfbench.problems.knn_graph import knn_graph
from perfbench.reference.sparse import Reference
from perfbench.trace import TraceSummary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
CELL = "knn32_graph_1m.matvec"
N = 4096
TOL = 1e-5
SEEDS = (13, 2 ** 31 + 9)
STAGES = ("stream.csr", "stream.rcm", "stream.layout")
K2_KERNEL = ("void csr_spmv_blocks<256>(int const*, int const*, float "
             "const*, int const*, int, float const*, float*)")


@pytest.fixture(scope="module")
def graph():
    return knn_graph(N, 32, 2, 7)


def _scaled(lap):
    """The scaling of the bench fixtures, before their RCM step."""
    lap = (lap / (abs(lap).sum(axis=1).max() * 1.01)).tocsr()
    lap.sort_indices()
    return lap


@pytest.mark.parametrize("source", ["bench_twin", "jax_bench"])
def test_problem_is_the_fixture_before_rcm(graph, source):
    rows, cols, vals, n = graph
    knn = (bench_stream.knn_laplacian if source == "bench_twin"
           else jax_bench.knn_laplacian)
    want = _scaled(knn(N))
    assert n == N and rows.dtype == cols.dtype == np.int32
    assert vals.dtype == np.float64
    assert np.array_equal(np.diff(want.indptr),
                          np.bincount(rows, minlength=n))
    assert np.array_equal(cols, want.indices)
    assert np.array_equal(vals, want.data.astype(np.float64))


def test_problem_is_row_sorted_in_the_points_order(graph):
    """Rows ascend, columns ascend within each row, and the order is the
    points' (unbanded: RCM shrinks the bandwidth many times over)."""
    rows, cols, _, n = graph
    key = rows.astype(np.int64) * n + cols
    assert np.all(np.diff(key) > 0)
    A = sp.csr_matrix((np.ones(rows.shape[0]), (rows, cols)), shape=(n, n))
    B, _ = rcm_csr(A)
    assert _bandwidth(A) > 8 * _bandwidth(B)


def _bandwidth(M):
    coo = M.tocoo()
    return int(np.abs(coo.row - coo.col).max())


def _operator(graph, reorder=True):
    rows, cols, vals, n = graph
    A = SparseOperator.from_coo(rows, cols, vals, (n, n),
                                dtype=torch.float32, coalesce=False,
                                device="cpu")
    return stream_operator(A, reorder=reorder, transpose=False)


def _rel(y, want):
    return float((y.double() - want).abs().max() / want.abs().max())


def test_caller_order_apply_matches_the_reference(graph):
    op = _operator(graph)
    assert op.perm is not None and op.bwd is None
    ref = Reference(*graph, "cpu")
    control = Reference(*graph, "cpu", torch.bfloat16)
    for k, seed in enumerate((0, 1, 2)):
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            N).astype(np.float32))
        want = ref.matvec(x)
        assert _rel(op.matvec(x), want) <= TOL
        assert _rel(control.matvec(x), want) > 100 * TOL
        assert op.gathers == 2 * (k + 1)


def test_caller_order_needs_the_gathers(graph):
    """Without the gathers K2's order is not the caller's: the apply of
    the RCM CSR alone is far from A x."""
    op = _operator(graph)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        N).astype(np.float32))
    want = Reference(*graph, "cpu").matvec(x)
    assert _rel(op.fwd(x), want) > 0.1


def _tiny_root(tmp):
    """BENCHMARK.json and the benchmark's files under `tmp`, the cell's
    configuration cut to N points and its pool to the minimum."""
    shutil.copytree(BENCH, os.path.join(tmp, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    for path, changes in (
            (("configs", "knn32_graph_1m.json"),
             {"points": N, "rows": N}),
            (("traffic", "graph_matvec.json"),
             {"pool_bytes": 0, "trace_items": 2, "chunk": 16,
              "warmup_chunks": 1})):
        full = os.path.join(tmp, "perfbench", *path)
        with open(full) as f:
            d = json.load(f)
        d.update(changes)
        with open(full, "w") as f:
            json.dump(d, f)
    return tmp


RUNS = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from perfbench import harness
cell = harness.Cell({cell!r}, {tiny!r})
calibrate = harness.load_module({calibrate!r}, "perfbench_cal_graph")
out = {{"program": [harness.execute(cell, s, 0.3, False, "cpu",
                                   time.perf_counter())
                   for s in {seeds!r}],
       "traced": harness.execute(cell, {seeds!r}[0], 0.3, True, "cpu",
                                 time.perf_counter()),
       "control": calibrate.control(cell, torch.device("cpu"),
                                    list({seeds!r}), 0.3)}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The cell through the harness at N points, in a fresh process (the
    harness refuses to measure where JAX is loaded, as it is in this
    one): the program on each seed, a traced run, and the control."""
    tiny = _tiny_root(str(tmp_path_factory.mktemp("tiny")))
    code = RUNS.format(root=ROOT, cell=CELL, tiny=tiny, seeds=SEEDS,
                       calibrate=os.path.join(BENCH, "calibrate.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_cell_found_by_name():
    cell = harness.Cell(CELL)
    assert cell.chips == 1 and cell.config["problem"] == "knn_graph"
    assert cell.config["layout"] == {"reorder": True, "transpose": False}
    assert cell.traffic["loop"] == "graph_matvec"
    assert {k: v for k, v in cell.traffic.items() if k != "what"} == {
        **{k: v for k, v in harness.read_json(os.path.join(
            BENCH, "traffic", "matvec.json")).items() if k != "what"},
        "loop": "graph_matvec"}
    assert set(cell.limits()) == {"max_rel_err"}
    e2e = {m["name"] for m in cell.end_to_end({"edges_per_s": 0})}
    assert e2e == {"edges_per_s", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer(e2e)}
    assert names == {"k2_roofline.graph_matvec", "graph_matvec_hbm_mfu_pct",
                     "perm_device_us.graph_matvec",
                     "k2_enqueue_us.graph_matvec",
                     "device_idle_pct.graph_matvec", "stream_setup_s"}
    entry = {c["name"]: c for c in cell.spec["configs"]}["knn32_graph_1m"]
    assert entry["reduced"] == [] and len(entry["source"]) <= 200


def test_program_passes_control_fails(tiny_runs):
    for seed, out in zip(SEEDS, tiny_runs["program"]):
        assert out["correct"], (seed, out["checks"])
        assert out["checks"]["max_rel_err"]["value"] <= TOL
        assert out["failed"] == 0 and out["attempted"] > 0
        assert set(out["metrics"]) == {"edges_per_s", "peak_mem_gib",
                                       "setup_s"}
    assert not any(o["correct"] for o in tiny_runs["control"])


def test_traced_run_reads_the_stages(tiny_runs):
    """On the CPU no span has device time and K2 runs its plain version
    (no launch): the set-up's stages are read, and the readers of the
    card's numbers leave theirs out."""
    out = tiny_runs["traced"]
    assert out["correct"]
    assert out["metrics"]["stream_setup_s"]["value"] > 0
    assert "graph_matvec_hbm_mfu_pct" in out["metrics"]
    for name in ("k2_roofline.graph_matvec", "perm_device_us.graph_matvec",
                 "k2_enqueue_us.graph_matvec"):
        assert name not in out["metrics"]


def test_stages_spans_and_counter_under_a_profiler(graph):
    """Building the operator is three stages, once each (always timed);
    under a CPU profiler each apply is two `stream.perm` spans and two
    counted gathers. `k2.launch` is K2's enqueue, on the card alone: the
    CPU's plain version records none. A `reorder=False` operator takes
    no ordering stage and no gather."""
    from torch.profiler import ProfilerActivity, profile

    prog.reset()
    op = _operator(graph)
    rep = prog.report()
    assert [rep[s]["calls"] for s in STAGES] == [1, 1, 1]
    assert all(rep[s]["host_s"] > 0 and rep[s]["parent"] is None
               for s in STAGES)
    x = torch.ones(N)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(3):
            op.matvec(x)
    rep = prog.report()
    assert rep["stream.perm"]["calls"] == 6 == op.gathers
    assert rep["stream.perm"]["device_calls"] == 0
    assert "k2.launch" not in rep
    names = {ev.name for ev in p.events()}
    assert prog.PREFIX + "stream.perm" in names

    prog.reset()
    plain = _operator(graph, reorder=False)
    with profile(activities=[ProfilerActivity.CPU]):
        plain.matvec(x)
    rep = prog.report()
    assert "stream.rcm" not in rep and "stream.perm" not in rep
    assert [rep[s]["calls"] for s in ("stream.csr", "stream.layout")] == [
        1, 1]
    assert plain.perm is None and plain.gathers == 0
    prog.reset()


# ---------------------------------------------------------------- readers
def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "perfbench_metric_" + name.replace(".", "_"))


def _entry(calls=0, host_s=0.0, device_calls=0, device_s=0.0):
    return {"calls": calls, "host_s": host_s, "device_calls": device_calls,
            "device_s": device_s, "self_device_s": device_s,
            "parent": None}


NNZ, ROWS = 37230400, 1048576
FLOOR_S = (NNZ * 4 + 2 * ROWS * 4) / 3.35e12   # 46.96 us an apply
# 8 traced chunks of 256 applies, each two gathers; 10 chunks' spans
# (the throwaway profile's two besides)
COUNTERS = {"k2_graph": 2048, "perm_gathers": 4096}
REGISTRY = {"stream.perm": _entry(calls=5120, host_s=5120 * 8e-6),
            "k2.launch": _entry(calls=2560, host_s=2560 * 12e-6),
            "stream.csr": _entry(calls=1, host_s=2.0),
            "stream.rcm": _entry(calls=1, host_s=3.5),
            "stream.layout": _entry(calls=1, host_s=0.5)}


def _run_stub(k2_s=2048 * 120e-6):
    kernels = {K2_KERNEL: (k2_s, 2048),
               "void at::native::index_elementwise_kernel": (0.04, 4096),
               "void at::native::vectorized_gather_kernel": (0.01, 10)}
    return SimpleNamespace(
        trace=TraceSummary(window_s=0.31, busy_s=0.3, kernels=kernels,
                           idle={}, host_calls={}),
        segment={"items": 8, "counters": dict(COUNTERS)},
        info={"levels": [{"n": ROWS, "nnz": NNZ, "kind": "k2"}]},
        window={"items_attempted": 256000, "seconds": 30.0},
        problem=(np.zeros(NNZ, np.int8), None, None, ROWS),
        cell=SimpleNamespace(chips=1))


def test_device_readers(monkeypatch):
    run = _run_stub()
    assert _reader("k2_roofline.graph_matvec").read(run) == pytest.approx(
        100 * FLOOR_S / 120e-6)
    assert _reader("graph_matvec_hbm_mfu_pct").read(run) == pytest.approx(
        100 * 256000 * FLOOR_S / 30.0)
    assert _reader("device_idle_pct.graph_matvec").read(run) == \
        pytest.approx(100 * (1 - 0.3 / 0.31))
    assert _reader("perm_device_us.graph_matvec").read(run) == \
        pytest.approx(1e6 * 0.05 / 2048)
    assert _reader("k2_roofline.graph_matvec").read(
        _run_stub(k2_s=0.0)) is None
    run.trace.kernels = {K2_KERNEL: (0.25, 2048)}
    assert _reader("perm_device_us.graph_matvec").read(run) is None
    run.segment["counters"] = {}
    for name in ("k2_roofline.graph_matvec", "perm_device_us.graph_matvec"):
        assert _reader(name).read(run) is None


@pytest.mark.parametrize("name,want,needs", [
    ("k2_enqueue_us.graph_matvec", 12.0, ("k2.launch",)),
    ("stream_setup_s", 6.0, STAGES)])
def test_span_readers(monkeypatch, name, want, needs):
    read = _reader(name).read
    run = _run_stub()
    monkeypatch.setattr(prog, "report", lambda: dict(REGISTRY))
    assert read(run) == pytest.approx(want)
    for span in needs:
        monkeypatch.setattr(prog, "report", lambda: {
            k: v for k, v in REGISTRY.items() if k != span})
        assert read(run) is None, span
    monkeypatch.delattr(prog, "report")
    assert read(run) is None


def test_counters_of_a_port_that_counts_no_gathers():
    """The parent of this cell's port counts no gathers: the driver's
    counters then leave them out, and still count K2."""
    driver = harness.load_module(
        os.path.join(BENCH, "drivers", "graph_matvec.py"),
        "perfbench_driver_graph_matvec")
    drv = driver.Driver.__new__(driver.Driver)
    drv.op = SimpleNamespace(fwd=SimpleNamespace(launches=7))
    assert drv.counters() == {"k2_graph": 7}
    drv.op.gathers = 14
    assert drv.counters() == {"k2_graph": 7, "perm_gathers": 14}
