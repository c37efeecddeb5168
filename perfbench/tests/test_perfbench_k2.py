"""The reader of kernel K2's device time in the solve cells
(`k2_device_ms.solve`) on a hand-built trace: K2's kernels alone, over
the segment's solves, and None where no K2 kernel ran (a port whose
hierarchy keeps its levels and prolongations in COO)."""

import os
from types import SimpleNamespace

import pytest

from conftest import BENCH
from perfbench import harness
from perfbench.trace import TraceSummary

NAME = "k2_device_ms.solve"
K2_KERNEL = ("void csr_spmv_blocks<256>(int const*, int const*, float "
             "const*, int const*, int, float const*, float*)")


def _read(kernels, items=12):
    reader = harness.load_module(
        os.path.join(BENCH, "metrics", NAME + ".py"),
        "perfbench_metric_" + NAME.replace(".", "_"))
    t = TraceSummary(window_s=0.3, busy_s=0.25, kernels=kernels, idle={},
                     host_calls={})
    return reader.read(SimpleNamespace(trace=t, segment={"items": items}))


def test_declared_for_both_solve_cells():
    spec = harness.read_json(os.path.join(os.path.dirname(BENCH),
                                          "BENCHMARK.json"))
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"]) == (
        "device_trace", "multilevel operators", "solves_per_s")
    assert m["workloads"] == ["poisson2d_5pt_2048.solve",
                              "poisson3d_7pt_128.solve"]


def test_reads_k2_alone_over_the_solves():
    kernels = {K2_KERNEL: (0.030, 396),
               "dia_tiles_kernel<float>": (0.040, 500),
               "void at::native::indexFuncLargeIndex<float>": (0.050, 60),
               "csr_spmm_kernel": (0.5, 1)}
    assert _read(kernels) == pytest.approx(2.5)


@pytest.mark.parametrize("kernels,items", [
    ({"dia_tiles_kernel<float>": (0.04, 500),
      "void at::native::indexFuncLargeIndex<float>": (0.05, 60)}, 12),
    ({K2_KERNEL: (0.03, 396)}, 0)], ids=["coo_hierarchy", "no_solve"])
def test_none_without_k2_or_solves(kernels, items):
    assert _read(kernels, items) is None
