"""The two-grid cell (`poisson2d_5pt_1024.twogrid`): its configuration,
traffic mix, driver, limits and readers are found by name; its reference
imports neither JAX nor the port; at 64^2 on the CPU the program is
correct and the control (the reference in bfloat16 in the program's
place), a broken cycle and a broken interpolation are not; the readers'
arithmetic."""

import ast
import os
import time

import pytest
import torch

from conftest import BENCH, edit_json
from perfbench import harness

CELL = "poisson2d_5pt_1024.twogrid"
SEEDS = (11, 2 ** 31 + 5)
SPAN_READERS = {"tg_fine_device_ms.twogrid": ("tg.pre", "tg.residual",
                                              "tg.post"),
                "tg_coarse_device_ms.twogrid": ("tg.coarse",),
                "tg_transfer_device_ms.twogrid": ("tg.restrict",
                                                  "tg.prolong")}
SETUP_STAGES = ("tg.strength", "tg.split", "tg.interp", "tg.galerkin",
                "tg.taps", "tg.layout")


@pytest.fixture
def tiny_twogrid(tiny_root):
    bench = os.path.join(tiny_root, "perfbench")
    edit_json(os.path.join(bench, "configs", "poisson2d_5pt_1024.json"),
              grid=[64, 64])
    edit_json(os.path.join(bench, "traffic", "twogrid.json"), pool_bytes=0,
              trace_items=2)
    return tiny_root


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "perfbench_metric_" + name.replace(".", "_"))


def test_found_by_name():
    cell = harness.Cell(CELL)
    assert cell.chips == 1 and cell.config["problem"] == "poisson_fd"
    assert cell.traffic["loop"] == "twogrid"
    assert hasattr(harness.load_driver(cell), "Driver")
    assert set(cell.limits()) == {"p_rel_err", "x_rel_err",
                                  "galerkin_rel_err"}
    e2e = {m["name"] for m in cell.end_to_end(
        {"solves_per_s": 0, "solve_ms_p95": 0})}
    assert e2e == {"solves_per_s", "solve_ms_p95", "peak_mem_gib",
                   "setup_s"}
    names = [m["name"] for m in cell.per_layer(e2e)]
    assert len(names) == 11
    for name in names:
        assert callable(_reader(name).read), name


def test_reference_imports_neither_jax_nor_the_port():
    path = os.path.join(BENCH, "reference", "twogrid.py")
    seen = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            seen |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            seen.add(node.module.split(".")[0])
    assert seen <= {"__future__", "numpy", "torch", "perfbench"}, seen


def _run(root, seed, trace=False, driver_cls=None):
    return harness.execute(harness.Cell(CELL, root), seed, 0.3, trace, "cpu",
                           time.perf_counter(), driver_cls)


def test_program_passes_control_fails(tiny_twogrid):
    calibrate = harness.load_module(
        os.path.join(BENCH, "calibrate_twogrid.py"), "perfbench_cal_tg")
    for seed in SEEDS:
        out = _run(tiny_twogrid, seed)
        assert out["correct"], (seed, out["checks"])
        assert out["failed"] == 0 and out["attempted"] > 0
        assert set(out["metrics"]) == {"solves_per_s", "solve_ms_p95",
                                       "peak_mem_gib", "setup_s"}
    cell = harness.Cell(CELL, tiny_twogrid)
    outs = calibrate.control(cell, torch.device("cpu"), list(SEEDS), 0.3)
    assert not any(o["correct"] for o in outs)


def test_traced_run_reads_the_set_up_stages(tiny_twogrid):
    """On the CPU no span has device time; the stages are read."""
    out = _run(tiny_twogrid, SEEDS[0], trace=True)
    assert out["correct"]
    assert out["metrics"]["tg_setup_s"]["value"] > 0


@pytest.mark.parametrize("kind", ["state unchanged", "answer altered"])
def test_broken_cycle_is_not_correct(tiny_twogrid, monkeypatch, kind):
    from gnnla_tpu_torch.models.vcycle import StencilVCycle
    real = StencilVCycle.run

    def broken(self, b, x):
        if kind == "state unchanged":
            return x.clone()
        y = real(self, b, x).clone()
        y[0] += 1.0
        return y
    monkeypatch.setattr(StencilVCycle, "run", broken)
    out = _run(tiny_twogrid, SEEDS[0])
    assert out["correct"] is False, out["checks"]


def test_broken_interpolation_is_not_correct(tiny_twogrid, monkeypatch):
    """A set-up whose direct interpolation weights are off by 1% fails
    the check of P against the reference's own."""
    import importlib
    vcycle = importlib.import_module("gnnla_tpu_torch.models.vcycle")
    real = vcycle._direct_interp_host
    monkeypatch.setattr(vcycle, "_direct_interp_host",
                        lambda *a: 1.01 * real(*a))
    out = _run(tiny_twogrid, SEEDS[0])
    assert out["correct"] is False
    assert out["checks"]["p_rel_err"]["value"] > \
        out["checks"]["p_rel_err"]["limit"]


class _Run:
    config = {"twogrid": {"n_cycles": 5}}


def _entry(host_s=0.0, device_calls=0, device_s=0.0, calls=0):
    return {"calls": calls, "host_s": host_s, "device_calls": device_calls,
            "device_s": device_s, "self_device_s": device_s,
            "parent": None}


def _registry(monkeypatch, spans):
    from gnnla_tpu_torch.utils import program
    monkeypatch.setattr(program, "report", lambda: dict(spans))


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_is_per_solve(monkeypatch, name):
    # 10 traced cycles = 2 solves; each named span 0.001 s a cycle
    reg = {"tg.cycle": _entry(device_calls=10, device_s=0.05)}
    reg.update({s: _entry(device_calls=10, device_s=0.01)
                for s in SPAN_READERS[name]})
    _registry(monkeypatch, reg)
    want = 5.0 * len(SPAN_READERS[name])
    assert _reader(name).read(_Run()) == pytest.approx(want)
    del reg[SPAN_READERS[name][-1]]
    _registry(monkeypatch, reg)
    assert _reader(name).read(_Run()) is None


def test_setup_reader_sums_the_six_stages(monkeypatch):
    reg = {s: _entry(host_s=0.5, calls=1) for s in SETUP_STAGES}
    _registry(monkeypatch, reg)
    assert _reader("tg_setup_s").read(None) == pytest.approx(3.0)
    del reg["tg.layout"]
    _registry(monkeypatch, reg)
    assert _reader("tg_setup_s").read(None) is None


def test_k4_floor_bytes():
    k4 = _reader("k4_roofline.twogrid")
    call = {"K": 5, "n": 1024 * 1024, "tap_bytes": 4, "mode": "affine"}
    assert k4.floor_bytes(call) == (5 + 3) * 4 * 1024 * 1024
    assert k4.floor_bytes(dict(call, mode="plain", tap_bytes=2)) == \
        (5 * 2 + 2 * 4) * 1024 * 1024


def _program_registry():
    # 12 traced solves of 5 cycle programs; the set-up's and the traced
    # run's captures
    return {"program.lookup": _entry(calls=60, host_s=60 * 40e-6),
            "program.inputs": _entry(calls=59, host_s=59 * 20e-6),
            "program.outputs": _entry(calls=59, host_s=59 * 30e-6),
            "program.warmup": _entry(calls=2, host_s=0.9),
            "program.capture": _entry(calls=2, host_s=0.3)}


@pytest.mark.parametrize("name,want,needs", [
    ("program_host_ms.twogrid", 5 * 0.09,
     ("program.lookup", "program.inputs", "program.outputs")),
    ("program_capture_s.twogrid", 0.6,
     ("program.warmup", "program.capture"))])
def test_program_readers(monkeypatch, name, want, needs):
    """Host ms a solve (five calls) and host s a capture; None without any
    of their spans."""
    reg = _program_registry()
    _registry(monkeypatch, reg)
    assert _reader(name).read(_Run()) == pytest.approx(want)
    for span in needs:
        _registry(monkeypatch, {k: v for k, v in reg.items() if k != span})
        assert _reader(name).read(_Run()) is None


def test_k2_reader_is_per_solve():
    from types import SimpleNamespace

    from perfbench.trace import TraceSummary

    k2 = ("void csr_spmv_blocks<256>(int const*, int const*, float "
          "const*, int const*, int, float const*, float*)")
    kernels = {k2: (0.0018, 120), "dia_tiles_kernel<float>": (0.04, 240)}
    t = TraceSummary(window_s=0.3, busy_s=0.25, kernels=kernels, idle={},
                     host_calls={})
    read = _reader("k2_device_ms.twogrid").read
    assert read(SimpleNamespace(trace=t, segment={"items": 12})) == \
        pytest.approx(0.15)
    del kernels[k2]
    assert read(SimpleNamespace(trace=t, segment={"items": 12})) is None
