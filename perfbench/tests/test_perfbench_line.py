"""The result line's shape, and the refusal to measure without a card."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from perfbench import harness

E2E = {"poisson2d_5pt_2048.solve": {"solves_per_s", "solve_ms_p95",
                                    "peak_mem_gib", "setup_s"},
       "poisson2d_5pt_2048.matvec": {"edges_per_s", "peak_mem_gib",
                                     "setup_s"}}


@pytest.mark.parametrize("workload", sorted(E2E))
def test_line_shape(tiny_root, workload):
    cell = harness.Cell(workload, tiny_root)
    for trace in (False, True):
        out = harness.execute(cell, 2 ** 31 + 99, 0.3, trace, "cpu",
                              time.perf_counter())
        line = json.loads(json.dumps(out))
        keys = list(line)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        assert keys[-1] == "checks"
        assert line["attempted"] > 0 and line["failed"] == 0
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        if not trace:
            assert set(line["metrics"]) == E2E[workload]
        else:
            spec = {m["name"] for m in cell.per_layer(E2E[workload])}
            assert set(line["metrics"]) <= spec
            assert "busy_s" in line["device"] and "window_s" in line["device"]
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "poisson2d_5pt_2048.matvec", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_refuses_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run (its card check passed over) fails before any result."""
    from conftest import copy_bench
    root = copy_bench(str(tmp_path))
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from perfbench import harness; "
            "out = harness.execute(harness.Cell("
            "'poisson2d_5pt_2048.matvec', '.'), 3, 1.0, False, 'cpu', "
            "time.perf_counter()); print(out)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "gnnla_tpu_torch" in out.stderr
