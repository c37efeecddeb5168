"""The reader of the coarsest Chebyshev's one-launch share
(`cheb_one_launch_pct.solve`): the port's tally of `chebyshev` calls
(`models/chebyshev.py::CHEB_TALLY`) as the cycles of a small SA hierarchy
fill it, on the CPU (the eager chain: 0) and with the form's card path
stubbed (every call one launch: 100); None where no call ran or the port
keeps no tally (an older port)."""

import importlib
import os
from types import SimpleNamespace

import pytest

from conftest import BENCH
from perfbench import harness

NAME = "cheb_one_launch_pct.solve"


def _read():
    reader = harness.load_module(
        os.path.join(BENCH, "metrics", NAME + ".py"),
        "perfbench_metric_" + NAME.replace(".", "_"))
    return reader.read(SimpleNamespace(trace=None, segment={}))


def _cheb_module():
    return importlib.import_module("gnnla_tpu_torch.models.chebyshev")


def test_declared_for_both_solve_cells():
    spec = harness.read_json(os.path.join(os.path.dirname(BENCH),
                                          "BENCHMARK.json"))
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"],
            m["better"]) == ("program_counter", "multilevel operators",
                             "solves_per_s", "%", "higher")
    assert m["workloads"] == ["poisson2d_5pt_2048.solve",
                              "poisson3d_7pt_128.solve"]


@pytest.mark.parametrize("one_launch", [False, True],
                         ids=["cpu_eager", "form_stubbed"])
def test_reads_the_share_the_cycles_tally(monkeypatch, one_launch):
    """Three V-cycles of the 24^2 Laplacian's SA hierarchy (K1 levels):
    one `chebyshev` call a cycle at the coarsest; on CPU tensors none
    takes the form, with the form's rule and launch stubbed every one."""
    import torch

    from gnnla_tpu_torch.models import (multigrid_cycle, setup_sa_multigrid,
                                        setup_with_dia_multigrid)
    from gnnla_tpu_torch.ops import dia_spmv
    from gnnla_tpu_torch.problems import laplacian_2d

    tally = SimpleNamespace(calls=0, one_launch=0)
    monkeypatch.setattr(_cheb_module(), "CHEB_TALLY", tally)
    if one_launch:
        monkeypatch.setattr(dia_spmv.DiaKernelOperator, "takes_chebyshev",
                            lambda self, b, x, deg: True)
        monkeypatch.setattr(dia_spmv, "dia_tiles_chebyshev_cuda",
                            lambda tiles, b, x, alphas, betas: x)
    A = laplacian_2d(24, device="cpu").eliminate_zeros()
    mg = setup_with_dia_multigrid(setup_sa_multigrid(A, theta=0.08, seed=0),
                                  kernel=True)
    assert isinstance(mg.As[-1], dia_spmv.DiaKernelOperator)
    b = torch.ones(A.n_rows)
    x = torch.zeros_like(b)
    for _ in range(3):
        x = multigrid_cycle(mg, b, x, n_pre=1, n_post=1)
    assert (tally.calls, tally.one_launch) == (3, 3 if one_launch else 0)
    assert _read() == (100.0 if one_launch else 0.0)


def test_none_without_a_call_or_a_tally(monkeypatch):
    module = _cheb_module()
    monkeypatch.setattr(module, "CHEB_TALLY",
                        SimpleNamespace(calls=0, one_launch=0))
    assert _read() is None
    monkeypatch.delattr(module, "CHEB_TALLY")
    assert _read() is None
