"""The reader of K1's fused share in the solve cells
(`k1_fused_pct.solve`) on a hand-built trace: the launches of K1's
Jacobi and residual forms over all K1 launches, None without K1, and the
fused forms' names still K1's to the other readers (`readers.K1`)."""

import os
from types import SimpleNamespace

import pytest

from conftest import BENCH
from perfbench import harness, readers
from perfbench.trace import TraceSummary

NAME = "k1_fused_pct.solve"
PLAIN = "void (anonymous namespace)::dia_tiles_kernel<float, false>"
SPLIT = "void (anonymous namespace)::dia_tiles_split_kernel<float, true>"
FUSED = ["void (anonymous namespace)::dia_tiles_jacobi_kernel<float, false>",
         "void (anonymous namespace)::dia_tiles_split_jacobi_kernel"
         "<__nv_bfloat16, true>",
         "void (anonymous namespace)::dia_tiles_residual_kernel<float, true>",
         "void (anonymous namespace)::dia_tiles_split_residual_kernel"
         "<float, false>"]
K2_KERNEL = "void csr_spmv_blocks<256>(int const*, int const*)"


def _trace(kernels):
    return TraceSummary(window_s=0.3, busy_s=0.25, kernels=kernels, idle={},
                        host_calls={})


def _read(kernels):
    reader = harness.load_module(
        os.path.join(BENCH, "metrics", NAME + ".py"),
        "perfbench_metric_" + NAME.replace(".", "_"))
    return reader.read(SimpleNamespace(trace=_trace(kernels),
                                       segment={"items": 12}))


def test_declared_for_both_solve_cells():
    spec = harness.read_json(os.path.join(os.path.dirname(BENCH),
                                          "BENCHMARK.json"))
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "device_trace", "multilevel operators", "solves_per_s", "%")
    assert m["workloads"] == ["poisson2d_5pt_2048.solve",
                              "poisson3d_7pt_128.solve"]


def test_share_of_k1_launches():
    """The 2-D solve's mix: 162 fused launches a solve against 81 plain
    ones (the coarsest Chebyshev's 72, CG's 9), over 12 solves; K2 and
    PyTorch's kernels count for neither side."""
    kernels = {FUSED[0]: (0.010, 12 * 18), FUSED[1]: (0.008, 12 * 90),
               FUSED[2]: (0.003, 12 * 9), FUSED[3]: (0.004, 12 * 45),
               PLAIN: (0.002, 12 * 9), SPLIT: (0.004, 12 * 72),
               K2_KERNEL: (0.018, 12 * 18),
               "void at::native::vectorized_elementwise_kernel": (0.01, 999)}
    assert _read(kernels) == pytest.approx(100 * 162 / 243)


@pytest.mark.parametrize("kernels,want", [
    ({PLAIN: (0.04, 500), SPLIT: (0.01, 100)}, 0.0),
    ({FUSED[0]: (0.04, 500)}, 100.0),
    ({K2_KERNEL: (0.03, 396)}, None),
    ({}, None)], ids=["parent", "fused_only", "no_k1", "empty"])
def test_without_fused_forms_or_k1(kernels, want):
    assert _read(kernels) == want


def test_none_without_a_trace():
    reader = harness.load_module(
        os.path.join(BENCH, "metrics", NAME + ".py"), "k1_fused_no_trace")
    assert reader.read(SimpleNamespace(trace=None, segment={})) is None


def test_fused_names_are_k1_to_the_other_readers():
    """`k1_roofline.solve` and the breakdown read K1 by `readers.K1`: the
    fused forms' time counts as K1's."""
    t = _trace({name: (0.001, 1) for name in FUSED})
    assert t.seconds_matching(readers.K1) == pytest.approx(0.004)
    assert all(any(k in name.lower() for k in readers.K1) for name in FUSED)
