"""The reader of K2's warp-block share (`k2_warp_nnz_pct.solve`): the
port's tally of K2 launches (`ops/stream_spmv.py::K2_TALLY`) as the
launches of a small SA hierarchy's V-cycle fill it, their card paths
stubbed; 0 where no CSR has a row of 65 to 256 nonzeros; None where no
K2 kernel ran or the port keeps no tally (an older port)."""

import os
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH
from perfbench import harness

NAME = "k2_warp_nnz_pct.solve"


def _read():
    reader = harness.load_module(
        os.path.join(BENCH, "metrics", NAME + ".py"),
        "perfbench_metric_" + NAME.replace(".", "_"))
    return reader.read(SimpleNamespace(trace=None, segment={}))


def _hierarchy_k2(grid):
    """(CsrSpMV, launches a V(1,1) cycle) of every K2 operator of the SA
    hierarchy (theta 0.08) of the FD Laplacian on `grid`, with the levels
    of more than 18 diagonals on K2."""
    from gnnla_tpu_torch.models import (setup_sa_multigrid,
                                        setup_with_dia_multigrid)
    from gnnla_tpu_torch.ops.stream_op import StreamOperator
    from gnnla_tpu_torch.problems import laplacian_nd

    A = laplacian_nd(grid, device="cpu")[0]
    mg = setup_with_dia_multigrid(setup_sa_multigrid(A, theta=0.08, seed=0),
                                  max_offsets=18, kernel=True)
    last = mg.n_levels - 1
    ops = [(a.fwd, 8 if lvl == last else 3) for lvl, a in enumerate(mg.As)
           if isinstance(a, StreamOperator)]
    return ops + [(c, 1) for p in mg.Ps for c in (p.fwd, p.bwd)]


def test_declared_for_both_solve_cells():
    spec = harness.read_json(os.path.join(os.path.dirname(BENCH),
                                          "BENCHMARK.json"))
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "program_counter", "kernels", "solves_per_s", "%")
    assert m["workloads"] == ["poisson2d_5pt_2048.solve",
                              "poisson3d_7pt_128.solve"]


@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 48)],
                         ids=["3d_warp_rows", "2d_none"])
def test_reads_the_share_the_launches_tally(monkeypatch, grid):
    """Each K2 launch of one cycle on its card path (stubbed, x on the
    meta device): the share of the nonzeros in warp blocks, exactly; 0 on
    the 2-D hierarchy, whose rows are all short."""
    from gnnla_tpu_torch.ops import stream_spmv

    tally = SimpleNamespace(nnz=0, warp_nnz=0)
    monkeypatch.setattr(stream_spmv, "K2_TALLY", tally)
    monkeypatch.setattr(stream_spmv, "csr_spmv_cuda", lambda *a: a[3])
    ops = _hierarchy_k2(grid)
    for csr, n in ops:
        for _ in range(n):
            csr.launch(torch.empty(csr.shape[1], device="meta"), csr.vals)
    assert tally.nnz == sum(n * c.nnz for c, n in ops)
    want = 100.0 * sum(n * c.warp_nnz for c, n in ops) / tally.nnz
    assert _read() == pytest.approx(want, rel=1e-12)
    if len(grid) == 3:
        assert 0 < want < 100
    else:
        assert want == 0.0 and _read() == 0.0


def test_none_without_k2_or_a_tally(monkeypatch):
    from gnnla_tpu_torch.ops import stream_spmv

    monkeypatch.setattr(stream_spmv, "K2_TALLY",
                        SimpleNamespace(nnz=0, warp_nnz=0))
    assert _read() is None
    monkeypatch.delattr(stream_spmv, "K2_TALLY")
    assert _read() is None
