"""Spans and stages (`gnnla_tpu_torch/utils/program.py`) on the CPU: off
outside a profiler, the solve's `gnnla.*` ranges nested as the cycle
nests under one, self times, the SA set-up's stages against its wall
time, a program on the CPU still its function, and `report`/`reset`.

A graph's device spans come from timing events in a captured CUDA graph,
which only the card has (`tests/test_torch_gpu.py`, marked `gpu`); here
their arithmetic runs on stand-in events.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnnla_tpu_torch.models.krylov import mg_pcg
from gnnla_tpu_torch.models.multigrid import (setup_sa_multigrid,
                                              setup_with_dia_multigrid)
from gnnla_tpu_torch.problems import laplacian_2d
from gnnla_tpu_torch.utils import program as prog

CPU = "cpu"
N_ITERS = 3
SA_STAGES = ("sa.to_host", "sa.strength", "sa.aggregate", "sa.prolongator",
             "sa.galerkin", "sa.to_device")


@pytest.fixture(autouse=True)
def empty_registry():
    prog.reset()
    yield
    prog.reset()


@pytest.fixture(scope="module")
def hierarchy():
    A = laplacian_2d(64, device=CPU).eliminate_zeros()
    mg = setup_with_dia_multigrid(setup_sa_multigrid(A), kernel=True)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.n_rows).astype(np.float32))
    return A, mg, b


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _solve(mg, b):
    return mg_pcg(mg, b, torch.zeros_like(b), n_iters=N_ITERS,
                  flip_sign=True)


def test_spans_are_off_outside_a_profiler(hierarchy):
    """No profiler: `span` is the shared null context, and a whole solve
    leaves the registry as it was."""
    _, mg, b = hierarchy
    assert not torch.autograd.profiler._is_profiler_enabled
    assert prog.span("pcg") is prog._OFF
    assert prog.span("mg.level", 3) is prog._OFF
    _solve(mg, b)
    assert prog.report() == {}
    assert prog._OPEN.get() == ()


def test_a_capture_while_off_records_no_device_span():
    rec = prog._Record()
    with prog._recording(rec):
        with prog.span("pcg"):
            with prog.span("mg.level", 0):
                pass
    assert rec.spans == rec.open == rec.closed == []


def test_a_profiled_eager_solve_leaves_nested_ranges(hierarchy):
    """Under a CPU profiler, eager `mg_pcg` leaves `gnnla.pcg`,
    `gnnla.mg.cycle` and one `gnnla.mg.level<l>` for every level, each
    cycle inside the solve and each level inside the one above it; the
    registry counts the calls and names the same parents."""
    _, mg, b = hierarchy
    L = mg.n_levels
    with _cpu_profile() as p:
        _solve(mg, b)
    events = {}
    for ev in p.events():
        if ev.name.startswith(prog.PREFIX):
            events.setdefault(ev.name[len(prog.PREFIX):], []).append(
                (ev.time_range.start, ev.time_range.end))
    levels = [f"mg.level{lvl}" for lvl in range(L)]
    assert set(events) == {"pcg", "mg.cycle", *levels}
    cycles = N_ITERS + 1
    assert len(events["pcg"]) == 1
    assert all(len(events[k]) == cycles for k in ("mg.cycle", *levels))

    def inside(inner, outer):
        return all(any(o0 <= i0 and i1 <= o1 for o0, o1 in events[outer])
                   for i0, i1 in events[inner])

    assert inside("mg.cycle", "pcg") and inside("mg.level0", "mg.cycle")
    for lvl in range(1, L):
        assert inside(levels[lvl], levels[lvl - 1])
    rep = prog.report()
    parents = {"pcg": None, "mg.cycle": "pcg", "mg.level0": "mg.cycle",
               **{levels[lvl]: levels[lvl - 1] for lvl in range(1, L)}}
    assert {k: rep[k]["parent"] for k in parents} == parents
    assert rep["pcg"]["calls"] == 1
    assert all(rep[k]["calls"] == cycles for k in ("mg.cycle", *levels))
    assert all(v["device_calls"] == 0 for v in rep.values())
    # a host span's time holds its children's
    assert rep["pcg"]["host_s"] >= rep["mg.cycle"]["host_s"] >= \
        rep["mg.level0"]["host_s"] > 0


class _Event:
    """A stand-in for a timing event: its time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _replayed(*spans):
    """A record of (name, parent index, start ms, end ms) spans, closed in
    the order of their end times."""
    rec = prog._Record()
    rec.spans = [[name, parent, _Event(t0), _Event(t1)]
                 for name, parent, t0, t1 in spans]
    rec.closed = sorted(range(len(spans)), key=lambda i: spans[i][3])
    return rec


def test_self_time_is_inclusive_time_less_the_children():
    """A replay's device spans: each span's self time is its own less its
    direct children's; two replays add up."""
    rec = _replayed(("pcg", -1, 0.0, 10.0), ("mg.cycle", 0, 1.0, 4.0),
                    ("mg.level0", 1, 1.5, 4.0), ("mg.level1", 2, 2.0, 3.0),
                    ("mg.cycle", 0, 5.0, 9.0))
    for _ in range(2):
        prog._read(rec)
    rep = prog.report()
    want = {"pcg": (2, 10.0, 3.0, None), "mg.cycle": (4, 7.0, 4.5, "pcg"),
            "mg.level0": (2, 2.5, 1.5, "mg.cycle"),
            "mg.level1": (2, 1.0, 1.0, "mg.level0")}
    for name, (calls, dev, own, parent) in want.items():
        got = rep[name]
        assert got["device_calls"] == calls and got["parent"] == parent
        assert got["device_s"] == pytest.approx(2e-3 * dev)
        assert got["self_device_s"] == pytest.approx(2e-3 * own)
        assert got["calls"] == 0 and got["host_s"] == 0.0
    total = sum(v["self_device_s"] for v in rep.values())
    assert total == pytest.approx(rep["pcg"]["device_s"])


def test_sa_stages_sum_to_no_more_than_the_set_up(hierarchy):
    """Every stage of `setup_sa_multigrid` is timed once a level (the
    coarsest's diagonal and interval once more), and together they take
    no longer than the set-up's wall time; `setup_with_dia_multigrid`
    times one `dia.layout` a level and, with kernel=True, one `k2.layout`
    a K2 twin (here each P: every level of the 64^2 hierarchy is on
    K1)."""
    A, _, _ = hierarchy
    t0 = time.perf_counter()
    mg = setup_sa_multigrid(A)
    wall = time.perf_counter() - t0
    rep = prog.report()
    steps = mg.n_levels - 1
    assert {k: rep[k]["calls"] for k in SA_STAGES} == {
        **{k: steps for k in SA_STAGES}, "sa.to_device": steps + 1}
    assert rep["sa.coarse_interval"]["calls"] == 1
    assert all(rep[k]["host_s"] > 0 for k in rep)
    assert sum(v["host_s"] for v in rep.values()) <= wall
    assert all(v["parent"] is None for v in rep.values())
    setup_with_dia_multigrid(mg, kernel=True)
    assert prog.report()["dia.layout"]["calls"] == mg.n_levels
    assert prog.report()["k2.layout"]["calls"] == steps


def test_a_stage_is_a_profiler_range_while_one_records(hierarchy):
    A, _, _ = hierarchy
    with _cpu_profile() as p:
        setup_sa_multigrid(A)
    names = {ev.name for ev in p.events()}
    assert {prog.PREFIX + k for k in SA_STAGES} <= names
    assert prog.PREFIX + "sa.coarse_interval" in names


def test_a_program_on_the_cpu_is_its_function():
    """On CPU tensors a program returns what its function returns, with
    no capture, replay or program span, profiled or not."""
    out = object()
    run = prog.program(lambda x, k=1: out)
    x = torch.ones(4)
    assert run(x) is out and run(x, k=2) is out
    with _cpu_profile():
        assert run(x) is out
    assert (run.captures, run.replays) == (0, 0)
    assert prog.report() == {}


def test_report_and_reset():
    """`report` gives each name's fields as a fresh dict; `reset` empties
    the registry."""
    for _ in range(2):
        with prog.stage("outer"):
            with _cpu_profile():
                with prog.span("inner"):
                    pass
    rep = prog.report()
    assert set(rep) == {"outer", "inner"}
    assert set(rep["inner"]) == {"calls", "host_s", "device_calls",
                                 "device_s", "self_device_s", "parent"}
    assert (rep["outer"]["calls"], rep["inner"]["calls"]) == (2, 2)
    assert (rep["outer"]["parent"], rep["inner"]["parent"]) == (None,
                                                                "outer")
    assert rep["outer"]["host_s"] >= rep["inner"]["host_s"] > 0
    rep["inner"]["calls"] = 99
    assert prog.report()["inner"]["calls"] == 2
    prog._read(_replayed(("pcg", -1, 0.0, 1.0)))
    assert prog.report()["pcg"]["device_calls"] == 1
    prog.reset()
    assert prog.report() == {}


def test_a_span_closes_when_its_body_raises():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with prog.span("failing"):
                raise ValueError("inside")
    assert prog._OPEN.get() == ()
    assert prog.report()["failing"]["calls"] == 1


def test_a_host_only_span_records_nothing_inside_a_capture():
    rec = prog._Record()
    with prog._recording(rec):
        state = prog.span_begin("k1.launch", host_only=True)
        prog.span_end(state)
    assert state is None and rec.spans == []
    assert prog.report() == {}
