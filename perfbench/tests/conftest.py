"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, with each configuration's grid cut and the pools at their
minimum. Tests drive the harness on it with the chip check skipped."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

TINY_GRIDS = {"poisson2d_5pt_2048": [24, 24], "poisson3d_7pt_128": [8, 8, 8]}


def copy_bench(dst: str) -> str:
    """BENCHMARK.json and the benchmark's files under `dst`."""
    shutil.copytree(BENCH, os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return dst


def edit_json(path: str, **changes) -> None:
    with open(path) as f:
        d = json.load(f)
    d.update(changes)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_bench(str(tmp_path))
    for name, grid in TINY_GRIDS.items():
        edit_json(os.path.join(root, "perfbench", "configs", name + ".json"),
                  grid=grid)
    for mix in ("solve", "matvec"):
        edit_json(os.path.join(root, "perfbench", "traffic", mix + ".json"),
                  pool_bytes=0, trace_items=2, chunk=16, warmup_chunks=1)
    return root


@pytest.fixture
def card():
    """The card, for the tests that need one; skips without it."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the benchmark measures only "
                    "there)")
    return torch.device("cuda", 0)
