"""The comparison that decides `correct` fails what it must: the control
(the plain reference computed in bfloat16, in the program's place) and,
with the chip check passed over, a whole run whose timed path is broken
underneath. The sound program passes. CPU, at the test size."""

import os
import time

import pytest
import torch

from conftest import BENCH
from perfbench import harness

calibrate = harness.load_module(os.path.join(BENCH, "calibrate.py"),
                                "perfbench_calibrate")
SEEDS = (11, 2 ** 31 + 5, 987654321)
CELLS = ("poisson2d_5pt_2048.solve", "poisson3d_7pt_128.solve",
         "poisson2d_5pt_2048.matvec")


def _run(root, workload, seed, driver_cls=None):
    return harness.execute(harness.Cell(workload, root), seed, 0.3, False,
                           "cpu", time.perf_counter(), driver_cls)


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_control_fails(tiny_root, workload):
    cell = harness.Cell(workload, tiny_root)
    for seed in SEEDS:
        assert _run(tiny_root, workload, seed)["correct"], seed
    outs = calibrate.control(cell, torch.device("cpu"), list(SEEDS), 0.3)
    assert len(outs) == len(SEEDS)
    assert not any(o["correct"] for o in outs)


def _solve_fault(kind):
    import gnnla_tpu_torch.models.krylov as krylov
    real = krylov.mg_pcg

    def broken(setup, b, x0, **kw):
        x, hist = real(setup, b, x0, **kw)
        if kind == "state unchanged":
            return x0.clone(), hist
        x = x.clone()
        x[0] += 1.0                       # an answer altered
        return x, hist
    return krylov, "mg_pcg", broken


def _matvec_fault(kind):
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
    real = DiaKernelOperator.matvec

    def broken(self, x):
        if kind == "state unchanged":
            return x.clone()
        y = real(self, x).clone()
        y[0] += 1.0                       # an answer altered
        return y
    return DiaKernelOperator, "matvec", broken


@pytest.mark.parametrize("kind", ["state unchanged", "answer altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(tiny_root, monkeypatch, workload, kind):
    fault = _solve_fault if workload.endswith(".solve") else _matvec_fault
    monkeypatch.setattr(*fault(kind))
    out = _run(tiny_root, workload, SEEDS[0])
    assert out["correct"] is False, out["checks"]
