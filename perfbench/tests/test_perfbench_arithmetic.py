"""The yardstick's arithmetic, counted by hand: the matrix builders and
the floor bytes of an apply."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

from perfbench import harness, roofline
from perfbench.problems import poisson_fd as problems


def _lil_laplacian(grid):
    """The FD Laplacian assembled entry by entry (the port's `lil` way),
    SPD convention."""
    n = int(np.prod(grid))
    A = sp.lil_matrix((n, n))
    for i, c in enumerate(np.ndindex(*grid)):
        A[i, i] = 2.0 * len(grid)
        for a in range(len(grid)):
            for d in (-1, 1):
                nb = list(c)
                nb[a] += d
                if 0 <= nb[a] < grid[a]:
                    A[i, np.ravel_multi_index(nb, grid)] = -1.0
    return A.tocsr()


@pytest.mark.parametrize("grid", [(4, 4), (3, 3, 3), (5, 3), (2, 3, 4), (7,)])
def test_builder_is_the_laplacian(grid):
    rows, cols, vals, n = problems.poisson_fd(grid)
    want = _lil_laplacian(grid)
    got = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    assert n == want.shape[0]
    assert abs(got - want).max() == 0
    assert rows.dtype == cols.dtype == np.int32
    # row-sorted, ascending columns, no duplicates: coalesce=False is safe
    key = rows.astype(np.int64) * n + cols
    assert np.all(np.diff(key) > 0)
    assert problems.nnz_poisson_fd(grid) == rows.shape[0]


def test_sizes_of_the_configurations():
    assert problems.nnz_poisson_fd([2048, 2048]) == 20963328
    assert problems.nnz_poisson_fd([128, 128, 128]) == 14581760


def test_floor_bytes_by_hand():
    # 4 x 4: 16 diagonal entries, 2 * 4 * 3 pairs each way = 48 off it
    assert problems.nnz_poisson_fd((4, 4)) == 64
    assert roofline.spmv_floor_bytes(64, 16) == 64 * 4 + 16 * 4 + 16 * 4
    # 3 x 3 x 3: 27 + 3 axes * 9 lines * 2 pairs * 2 directions = 135
    assert problems.nnz_poisson_fd((3, 3, 3)) == 135
    assert roofline.spmv_floor_bytes(135, 27) == 756
    # no index bytes, bf16 values, and a rectangular operator
    assert roofline.spmv_floor_bytes(10, 4, 6, value_bytes=2) == 20 + 24 + 16


def test_floor_and_share():
    b = roofline.HBM_BYTES_PER_S * 1e-3          # one ms of bytes
    assert roofline.floor_seconds(b) == pytest.approx(1e-3)
    assert roofline.floor_seconds(0, roofline.F32_FLOPS) == pytest.approx(1)
    assert roofline.share_pct(1e-3, 4e-3) == pytest.approx(25.0)
    assert roofline.share_pct(1e-3, 0.0) is None


def test_unknown_problem_refused(tiny_root):
    path = os.path.join(tiny_root, "perfbench", "configs",
                        "poisson3d_7pt_128.json")
    cfg = json.load(open(path))
    cfg["problem"] = "hpcg_27pt"
    json.dump(cfg, open(path, "w"))
    cell = harness.Cell("poisson3d_7pt_128.solve", tiny_root)
    with pytest.raises(ValueError, match="unknown problem 'hpcg_27pt'"):
        harness.build_problem(cell)


def test_problem_found_by_the_config_s_name(tiny_root):
    cell = harness.Cell("poisson2d_5pt_2048.matvec", tiny_root)
    rows, cols, vals, n = harness.build_problem(cell)
    assert n == 24 * 24 and rows.shape[0] == problems.nnz_poisson_fd((24, 24))
    cell.config.pop("problem")
    assert harness.build_problem(cell) is None


def test_idle_share_and_launch_gap_by_hand():
    from types import SimpleNamespace

    from perfbench import readers
    from perfbench.trace import TraceSummary

    t = TraceSummary(window_s=0.2, busy_s=0.15, kernels={},
                     idle={"solve > cudaGraphLaunch": 0.03,
                           "solve": 0.01, "sync > cudaDeviceSynchronize":
                           0.01}, host_calls={"cudaGraphLaunch": 10})
    run = SimpleNamespace(trace=t, segment={"items": 10})
    assert readers.idle_pct(run) == pytest.approx(25.0)
    assert readers.launch_gap_ms(run) == pytest.approx(3.0)
    t.host_calls = {"cudaLaunchKernel": 40}         # no program replayed
    assert readers.launch_gap_ms(run) is None
    run.trace = None
    assert readers.idle_pct(run) is None and readers.launch_gap_ms(run) is None
