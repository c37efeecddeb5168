"""The re-set-up cell (`lognormal2d_5pt_512.resetup`) on the CPU at a
small grid: found by name, its fields reproducible from the seed, the
program correct and the bfloat16 control not, its three checks failing on
a planted stale hierarchy (the previous item's) and on a level 0 held in
bfloat16, its readers' arithmetic, and a whole run that loads no JAX."""

import dataclasses
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, copy_bench, edit_json
from perfbench import harness
from perfbench.trace import TraceSummary

CELL = "lognormal2d_5pt_512.resetup"
CHECKS = ("res_rel", "a0_rel_err", "galerkin_rel_err")
READERS = ("sa_setup_ms.resetup", "layout_ms.resetup", "capture_ms.resetup",
           "solve_device_ms.resetup", "device_idle_pct.resetup",
           "live_graphs.resetup")
SEED = 2 ** 31 + 77


@pytest.fixture
def tiny(tmp_path):
    """The benchmark with the cell cut to a 24^2 grid, 3 fields and the
    smallest pool."""
    root = copy_bench(str(tmp_path))
    bench = os.path.join(root, "perfbench")
    edit_json(os.path.join(bench, "configs", "lognormal2d_5pt_512.json"),
              grid=[24, 24])
    edit_json(os.path.join(bench, "traffic", "resetup.json"), pool_bytes=0,
              fields_pool=3, trace_items=2, warmup_items=1)
    return harness.Cell(CELL, root)


def _driver():
    return harness.load_module(os.path.join(BENCH, "drivers", "resetup.py"),
                               "perfbench_driver_resetup_test")


def test_cell_mix_and_driver_found_by_name():
    cell = harness.Cell(CELL)
    assert cell.chips == 1 and cell.config["problem"] == "lognormal_fv"
    assert cell.config["grid"] == [512, 512]
    assert cell.config["field"] == {"sigma2": 1.0, "lambda": 0.3}
    assert cell.traffic["loop"] == "resetup"
    assert cell.traffic["fields_pool"] == 16
    assert set(cell.limits()) == set(CHECKS)
    assert cell.limits()["res_rel"]["limit"] == cell.config["pcg"]["tol"]
    assert harness.load_driver(cell).__file__.endswith("drivers/resetup.py")
    rows, cols, vals, n = harness.build_problem(cell)
    assert (n, rows.shape[0]) == (cell.config["rows"],
                                  cell.config["nonzeros"])
    e2e = {m["name"] for m in cell.end_to_end(
        {"solves_per_s": 0, "solve_ms_p95": 0})}
    assert e2e == {"solves_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer(e2e)} == set(READERS)
    entry = {c["name"]: c for c in cell.spec["configs"]}[
        "lognormal2d_5pt_512"]
    assert entry["reduced"] == ["grid"] == cell.config["reduced"]


def test_fields_are_reproducible_from_the_seed(tiny):
    def values(seed):
        run = harness.Run(tiny, seed, 1.0, "cpu")
        run.problem = harness.build_problem(tiny)
        drv = _driver().Driver(run)
        drv.build()
        return drv.vals64, drv.vals32

    a64, a32 = values(SEED)
    b64, _ = values(SEED)
    c64, _ = values(SEED + 1)
    assert len(a64) == 3
    for u, v, w in zip(a64, b64, c64):
        np.testing.assert_array_equal(u, v)
        assert not np.array_equal(u, w)
    assert not np.array_equal(a64[0], a64[1])
    assert all(v.dtype == np.float32 for v in a32)


def _run(cell, driver_cls=None, trace=False, seed=SEED):
    return harness.execute(cell, seed, 0.4, trace, "cpu",
                           time.perf_counter(), driver_cls=driver_cls)


def test_program_is_correct(tiny):
    out = _run(tiny)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    lim = tiny.limits()
    for name in CHECKS:
        assert out["checks"][name]["value"] <= lim[name]["limit"]
    assert set(out["metrics"]) == {"solves_per_s", "peak_mem_gib",
                                   "setup_s"}


def test_traced_run_reads_the_host_stages(tiny):
    """On the CPU the stages are read; a program is its function (no
    capture, no live graph) and no device time exists."""
    out = _run(tiny, trace=True)
    assert out["correct"]
    got = out["metrics"]
    assert got["sa_setup_ms.resetup"]["value"] > 0
    assert got["layout_ms.resetup"]["value"] > 0
    for name in ("capture_ms.resetup", "solve_device_ms.resetup",
                 "device_idle_pct.resetup"):
        assert name not in got


def _stale():
    """Each item set up from the previous item's field: its x, its levels
    and its P0 are the previous item's hierarchy's."""
    base = _driver().Driver

    class Stale(base):
        def hierarchy(self, k):
            return super().hierarchy((k - 1) % len(self.vals32))

    return Stale


def _bf16_level0():
    """Level 0 set up from the field's values rounded to bfloat16 (the
    solve and its check run on it); the rest of the hierarchy exact."""
    from gnnla_tpu_torch.ops.dia_spmv import dia_twin
    from gnnla_tpu_torch.ops.sparse import SparseOperator

    base = _driver().Driver

    class Bf16(base):
        def hierarchy(self, k):
            sa, mg = super().hierarchy(k)
            vals = torch.from_numpy(self.vals32[k]).bfloat16().float()
            A0 = SparseOperator.from_coo(self.rows, self.cols, vals.numpy(),
                                         (self.n, self.n), coalesce=False,
                                         device="cpu")
            return sa, dataclasses.replace(
                mg, As=(dia_twin(A0, 512, kernel=True),) + mg.As[1:])

    return Bf16


def test_checks_fail_on_a_stale_hierarchy(tiny):
    out = _run(tiny, _stale())
    assert not out["correct"]
    for name in CHECKS:
        c = out["checks"][name]
        assert c["value"] > 10 * c["limit"], (name, c)


def test_checks_fail_on_a_bfloat16_level_0(tiny):
    out = _run(tiny, _bf16_level0())
    assert not out["correct"]
    for name in ("res_rel", "a0_rel_err"):
        c = out["checks"][name]
        assert c["value"] > 10 * c["limit"], (name, c)
    c = out["checks"]["galerkin_rel_err"]
    assert c["value"] <= c["limit"]   # level 1 is the exact field's


def test_control_is_not_correct(tiny):
    cal = harness.load_module(os.path.join(BENCH, "calibrate_resetup.py"),
                              "perfbench_cal_resetup_test")
    (out,) = cal.control(tiny, torch.device("cpu"), [SEED], 0.4)
    assert not out["correct"]
    for name in CHECKS:
        c = out["checks"][name]
        assert c["value"] > c["limit"], (name, c)


# ---------------------------------------------------------------- readers
def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "perfbench_metric_" + name.replace(".", "_"))


def _entry(calls, host_s):
    return {"calls": calls, "host_s": host_s, "device_calls": 0,
            "device_s": 0.0, "self_device_s": 0.0, "parent": None}


# 20 set-ups of 5 levels: per level stages 100 calls, per set-up 20
REGISTRY = {"sa.to_host": _entry(100, 1.0), "sa.strength": _entry(100, 0.5),
            "sa.aggregate": _entry(100, 2.0),
            "sa.prolongator": _entry(100, 3.0),
            "sa.galerkin": _entry(100, 1.5), "sa.to_device": _entry(120, 1.2),
            "sa.coarse_interval": _entry(20, 0.8),
            "dia.layout": _entry(120, 2.4), "k2.layout": _entry(100, 0.6),
            "program.warmup": _entry(18, 0.9),
            "program.capture": _entry(18, 1.08)}
EXPECT = {"sa_setup_ms.resetup": 1e3 * 10.0 / 20,
          "layout_ms.resetup": 1e3 * 3.0 / 20,
          "capture_ms.resetup": 1e3 * 1.98 / 18}


@pytest.mark.parametrize("name,drop", [
    ("sa_setup_ms.resetup", "sa.coarse_interval"),
    ("layout_ms.resetup", "k2.layout"),
    ("capture_ms.resetup", "program.capture")])
def test_span_readers(monkeypatch, name, drop):
    from gnnla_tpu_torch.utils import program

    read = _reader(name).read
    run = SimpleNamespace(info={})
    monkeypatch.setattr(program, "report", lambda: dict(REGISTRY))
    assert read(run) == pytest.approx(EXPECT[name])
    monkeypatch.setattr(program, "report", lambda: {
        k: v for k, v in REGISTRY.items() if k != drop})
    assert read(run) is None
    monkeypatch.delattr(program, "report")
    assert read(run) is None


def test_device_and_counter_readers():
    trace = TraceSummary(window_s=4.0, busy_s=0.04, kernels={}, idle={},
                         host_calls={})
    run = SimpleNamespace(trace=trace, segment={"items": 4},
                          info={"live_graphs": 1})
    assert _reader("solve_device_ms.resetup").read(run) == \
        pytest.approx(10.0)
    assert _reader("device_idle_pct.resetup").read(run) == \
        pytest.approx(99.0)
    assert _reader("live_graphs.resetup").read(run) == 1
    empty = SimpleNamespace(trace=None, segment={}, info={})
    for name in ("solve_device_ms.resetup", "device_idle_pct.resetup",
                 "live_graphs.resetup"):
        assert _reader(name).read(empty) is None


def test_driver_leaves_out_what_a_program_does_not_count():
    """A program that counts no `released` and no `live` (an older
    port): `counters()` leaves them out, and so does `live_graphs`."""
    drv = _driver().Driver.__new__(_driver().Driver)
    drv.prog = SimpleNamespace(captures=3, replays=0)
    assert drv.counters() == {"captures": 3, "replays": 0}
    drv.prog.released, drv.prog.live = 2, 1
    assert drv.counters() == {"captures": 3, "replays": 0, "released": 2}


MIB = 2 ** 20


@pytest.mark.parametrize("held, refused", [
    ([400 * MIB, 401 * MIB], False),            # flat: one hierarchy held
    ([400 * MIB, 399 * MIB, 400 * MIB], False),
    ([400 * MIB, 474 * MIB], True),             # each item's kept: +74 MiB
    ([400 * MIB, 440 * MIB, 480 * MIB], True)])
def test_items_that_leave_memory_held_are_refused(held, refused):
    """Set-up refuses a port whose items each leave more than half of what
    the first left held (base 330 MiB: the first left 70)."""
    check = _driver().refuse_growth
    if refused:
        with pytest.raises(RuntimeError, match="runs out of device memory"):
            check(330 * MIB, held)
    else:
        check(330 * MIB, held)


def test_a_run_loads_no_jax(tiny):
    code = f"""
import sys, time
sys.path.insert(0, {ROOT!r})
from perfbench import harness
harness.execute(harness.Cell({CELL!r}, {tiny.root!r}), 5, 0.2, True, "cpu",
                time.perf_counter())
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
