"""The port's utilities against the JAX package's on the CPU: the native
COO coalescing and CSR row pointers (through the library and through the
numpy fallback), the timer, the throughput counter, the metrics logger and
the trace context; and kernel K5's wrapper, plain version and probe on the
CPU. Arrays are compared exactly: both packages run the same native code
or the same numpy algorithm on the same float64 inputs."""

import json
import os
import time

import numpy as np
import pytest
import torch

from gnnla_tpu import native_ext as j_native
from gnnla_tpu.utils import metrics as j_metrics
from gnnla_tpu_torch import native_ext as t_native
from gnnla_tpu_torch.utils import health, metrics as t_metrics


def _coo(seed, nnz=600, n=50):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, nnz), rng.integers(0, n, nnz),
            rng.standard_normal(nnz), n)


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both packages through the shared library, or both through their
    numpy fallbacks."""
    if request.param == "native":
        if not (t_native.available() and j_native.available()):
            pytest.skip("native/libgnnla_native.so is not built")
    else:
        monkeypatch.setattr(t_native, "_load", lambda: None)
        monkeypatch.setattr(j_native, "_load", lambda: None)
    return request.param


@pytest.mark.parametrize("seed", [0, 1])
def test_coalesce_coo_identical(route, seed):
    rows, cols, vals, n = _coo(seed)
    keep = (rows.copy(), cols.copy(), vals.copy())
    got = t_native.coalesce_coo(rows, cols, vals, n)
    want = j_native.coalesce_coo(rows, cols, vals, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the callers' arrays are left as they were
    for a, b in zip((rows, cols, vals), keep):
        np.testing.assert_array_equal(a, b)
    # sorted by (row, col), no duplicates
    key = got[0] * n + got[1]
    assert (np.diff(key) > 0).all()


@pytest.mark.parametrize("n_rows", [20, 57])
def test_csr_row_ptr_identical(route, n_rows):
    rows = np.sort(np.random.default_rng(n_rows).integers(0, n_rows, 300))
    got = t_native.csr_row_ptr(rows, n_rows)
    np.testing.assert_array_equal(got, j_native.csr_row_ptr(rows, n_rows))
    assert got.dtype == np.int64 and got[-1] == rows.size


def test_timer_waits_and_measures():
    with t_metrics.Timer(device="cpu") as t:
        time.sleep(0.02)
    with j_metrics.Timer() as tj:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed_s < 1.0 and 0.02 <= tj.elapsed_s < 1.0
    # the device may be given as a tensor
    assert t_metrics.Timer(device=torch.zeros(1)).device.type == "cpu"


def test_timer_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_metrics.Timer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with t_metrics.profile_trace("unused"):
            pass


@pytest.mark.parametrize("args", [(5_238_784, 20, 0.5), (10, 3, 0.0),
                                  (0, 1, 1.0)])
def test_edges_per_second_matches(args):
    assert t_metrics.edges_per_second(*args) == \
        j_metrics.edges_per_second(*args)


def test_metrics_logger_writes_the_same_records(tmp_path):
    paths = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    loggers = (t_metrics.MetricsLogger(str(paths[0])),
               j_metrics.MetricsLogger(str(paths[1])))
    for lg in loggers:
        lg.log(0, loss=1.5, edges_per_s=2e9)
        lg.log(1, loss=0.25)
    recs = [[json.loads(ln) for ln in p.read_text().splitlines()]
            for p in paths]
    for rt, rj in zip(*recs):
        assert list(rt) == list(rj)  # same keys, same order
        rt.pop("time"), rj.pop("time")
        assert rt == rj
    assert [r["step"] for r in loggers[0].history] == [0, 1]
    assert t_metrics.MetricsLogger().history == []


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with t_metrics.profile_trace(str(tmp_path), device="cpu"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        assert "traceEvents" in json.load(f)


def test_health_probe_on_the_cpu():
    """K5's wrapper takes the plain version for a CPU tensor (no launch
    counted); the probe checks y == 2 exactly; the raw launcher refuses a
    CPU tensor."""
    call = health.HealthCall()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        health.SHAPE).astype(np.float32))
    assert torch.equal(call(x), 2.0 * x) and call.launches == 0
    assert health.health_probe(device="cpu", call=call) >= 0.0
    with pytest.raises(ValueError, match="not CUDA"):
        health.health_cuda(x)


def test_health_probe_raises_on_a_wrong_result(monkeypatch):
    """One ulp off anywhere fails the probe: it compares bitwise."""
    def one_ulp_high(x):
        y = 2.0 * x
        y[3, 7] = torch.nextafter(y[3, 7], torch.tensor(3.0))
        return y

    monkeypatch.setattr(health, "health_plain", one_ulp_high)
    with pytest.raises(RuntimeError, match="y != 2 x"):
        health.health_probe(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        health.health_probe()
