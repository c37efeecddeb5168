"""On the card only: each cell of BENCHMARK.json as the driver runs it,
for a one-second window: exit 0, a result line, `correct`."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"] if w["chips"] == 1]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(card, workload):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], line["checks"]
