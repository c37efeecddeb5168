"""A configuration, a traffic mix and a per-layer metric are files of
their own, found by name: adding them edits no file of the benchmark."""

import hashlib
import json
import os
import time

from perfbench import harness


def _digests(bench):
    out = {}
    for base, _, files in os.walk(bench):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                out[os.path.relpath(p, bench)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_config_mix_and_metric_need_no_edit(tiny_root):
    bench = os.path.join(tiny_root, "perfbench")
    before = _digests(bench)
    # a new configuration: 3-D, another grid
    cfg = json.load(open(os.path.join(bench, "configs",
                                      "poisson3d_7pt_128.json")))
    cfg.update(name="poisson3d_7pt_6", grid=[6, 6, 6])
    json.dump(cfg, open(os.path.join(bench, "configs",
                                     "poisson3d_7pt_6.json"), "w"))
    # a new mix on the matvec loop, and a new metric reader
    mix = json.load(open(os.path.join(bench, "traffic", "matvec.json")))
    mix.update(chunk=16, samples=3)
    json.dump(mix, open(os.path.join(bench, "traffic", "matvec_small.json"),
                        "w"))
    with open(os.path.join(bench, "metrics", "applies_per_item.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    return run.window['items_attempted'] / "
                "run.window['items']\n")
    spec = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    spec["configs"].append({"name": "poisson3d_7pt_6", "source": "test",
                            "file": "perfbench/configs/poisson3d_7pt_6.json",
                            "reduced": ["grid"], "why": "test"})
    spec["workloads"].append({"name": "poisson3d_7pt_6.matvec_small",
                              "config": "poisson3d_7pt_6",
                              "traffic": "matvec_small", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "applies_per_item", "unit": "applies",
                              "better": "higher", "source": "host_clock",
                              "layer": "kernels", "moves": "edges_per_s",
                              "workloads": ["poisson3d_7pt_6.matvec_small"]})
    for m in spec["end_to_end"]:
        if m["name"] == "edges_per_s":
            m["workloads"].append("poisson3d_7pt_6.matvec_small")
    json.dump(spec, open(os.path.join(tiny_root, "BENCHMARK.json"), "w"))

    cell = harness.Cell("poisson3d_7pt_6.matvec_small", tiny_root)
    assert cell.config["grid"] == [6, 6, 6]
    assert cell.traffic["chunk"] == 16
    out = harness.execute(cell, 5, 0.2, False, "cpu", time.perf_counter())
    assert "edges_per_s" in out["metrics"]
    out = harness.execute(cell, 5, 0.2, True, "cpu", time.perf_counter())
    assert out["metrics"]["applies_per_item"]["value"] == 16
    after = _digests(bench)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == set(), changed
    assert set(after) - set(before) == {
        "configs/poisson3d_7pt_6.json", "traffic/matvec_small.json",
        "metrics/applies_per_item.py"}


def _add_cell(root, config, cfg_file, traffic, cell):
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": config, "source": "test",
                            "file": "perfbench/configs/" + cfg_file,
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": config,
                              "traffic": traffic, "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "edges_per_s":
            m["workloads"].append(cell)
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))


PATH_PROBLEM = '''
import numpy as np


def build(config):
    n = int(config["n"])
    i = np.arange(n)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[:-1], i, i[1:]])
    vals = np.concatenate([-np.ones(n - 1), np.full(n, 2.0 + config["shift"]),
                           -np.ones(n - 1)])
    order = np.lexsort((cols, rows))
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            vals[order], n)
'''


def test_new_problem_kind_needs_no_edit(tiny_root):
    """Another kind of matrix: a file in problems/, a configuration that
    names it, and the cell's limits; the matvec loop runs it."""
    bench = os.path.join(tiny_root, "perfbench")
    before = _digests(bench)
    with open(os.path.join(bench, "problems", "shifted_path.py"), "w") as f:
        f.write(PATH_PROBLEM)
    json.dump({"name": "path_500", "problem": "shifted_path", "n": 500,
               "shift": 0.5, "dtype": "float32"},
              open(os.path.join(bench, "configs", "path_500.json"), "w"))
    json.dump({"max_rel_err": {"limit": 1e-4}},
              open(os.path.join(bench, "limits", "path_500.matvec.json"),
                   "w"))
    _add_cell(tiny_root, "path_500", "path_500.json", "matvec",
              "path_500.matvec")

    cell = harness.Cell("path_500.matvec", tiny_root)
    rows, cols, vals, n = harness.build_problem(cell)
    assert n == 500 and rows.shape[0] == 3 * 500 - 2
    out = harness.execute(cell, 2 ** 31 + 17, 0.2, False, "cpu",
                          time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["max_rel_err"]["value"] < 1e-6
    assert "edges_per_s" in out["metrics"]
    after = _digests(bench)
    assert {k for k in before if after.get(k) != before[k]} == set()
    assert set(after) - set(before) == {
        "problems/shifted_path.py", "configs/path_500.json",
        "limits/path_500.matvec.json"}


OWN_INPUTS_DRIVER = '''
import torch

from perfbench.generator import device_seed


class Driver:
    """y = d * x, d and x from the seed: a loop with no matrix."""

    def __init__(self, run):
        self.run = run

    def setup(self):
        assert self.run.problem is None
        n = int(self.run.config["n"])
        g = torch.Generator(device=self.run.device)
        g.manual_seed(device_seed(self.run.seed))
        self.d = torch.rand(n, generator=g, device=self.run.device) + 1.0
        self.x = torch.randn(n, generator=g, device=self.run.device)
        self.y = None

    def item(self, i, keep):
        y = self.d * self.x
        if keep:
            self.y = y

    def counters(self):
        return {}

    def end_to_end(self):
        w = self.run.window
        w["items_attempted"], w["items_failed"] = w["items"], 0
        return {"edges_per_s": len(self.x) * w["items"] / w["seconds"]}

    def release(self):
        pass

    def judge(self):
        want = self.d.double() * self.x.double()
        err = float((self.y.double() - want).abs().max())
        return {"max_abs_err": (err, 1e-6)}
'''


def test_config_with_no_matrix_and_its_own_loop(tiny_root):
    """A configuration that names no problem: `run.problem` stays None
    and the loop a new mix names makes its own inputs from the seed."""
    bench = os.path.join(tiny_root, "perfbench")
    before = _digests(bench)
    with open(os.path.join(bench, "drivers", "scale.py"), "w") as f:
        f.write(OWN_INPUTS_DRIVER)
    json.dump({"loop": "scale", "trace_items": 2},
              open(os.path.join(bench, "traffic", "scale.json"), "w"))
    json.dump({"name": "vector_4096", "n": 4096, "dtype": "float32"},
              open(os.path.join(bench, "configs", "vector_4096.json"), "w"))
    _add_cell(tiny_root, "vector_4096", "vector_4096.json", "scale",
              "vector_4096.scale")

    cell = harness.Cell("vector_4096.scale", tiny_root)
    assert harness.build_problem(cell) is None
    out = harness.execute(cell, 3, 0.1, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"edges_per_s", "setup_s", "peak_mem_gib"}
    after = _digests(bench)
    assert {k for k in before if after.get(k) != before[k]} == set()
    assert set(after) - set(before) == {
        "drivers/scale.py", "traffic/scale.json", "configs/vector_4096.json"}
