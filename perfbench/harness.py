"""One run of one cell: set-up, the measured window, the traced segment,
the check of the outputs, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration and a traffic mix in `BENCHMARK.json`; the
harness reads `configs/<config>.json` and `traffic/<traffic>.json`, builds
the matrix of the kind the configuration's "problem" names
(`problems/<problem>.py`), runs the driver that the mix's "loop" names
(`drivers/<loop>.py`), and with `--trace 1` the reader of each per-layer
metric that the cell reports (`metrics/<name>.py`). Adding a cell, a mix,
a kind of problem, a loop or a metric adds files and entries; no file here
changes. A configuration that names no problem leaves `run.problem` None,
and its driver makes its own inputs from the seed.

A driver module defines `Driver(run)` with:

    setup()         build the port's objects from the run's inputs, warm up
                    every shape the window uses
    item(i, keep)   one unit of traffic, synchronised at its end; `keep`
                    False in the traced segment, whose items the window's
                    numbers leave out
    end_to_end()    {metric: value} of the window
    release()       drop the port's state before the reference runs
    judge()         {check: (value, limit)} from the plain reference

`end_to_end()` gives the cell's end-to-end metrics besides `setup_s` and
`peak_mem_gib`, and `counters()` the port's launch counters. A per-layer
metric module defines `read(run)`, which returns a number or None
(nothing to read: the metric is left out).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gnnla_tpu")
GIB = 2.0 ** 30


class RefusedError(RuntimeError):
    """The run cannot measure: no card, too few cards, or JAX loaded."""


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`gnnla_tpu_torch` is not `gnnla_tpu`)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def build_problem(cell):
    """The matrix of the configuration's problem as (rows, cols, vals, n),
    from `problems/<problem>.py`; None when it names no problem."""
    kind = cell.config.get("problem")
    if kind is None:
        return None
    path = os.path.join(cell.dir, "problems", kind + ".py")
    if not os.path.exists(path):
        raise ValueError(f"unknown problem {kind!r}: no {path}")
    return load_module(path, "perfbench_problem_" + kind).build(cell.config)


def load_driver(cell):
    """The module of the driver that the cell's traffic mix names."""
    loop = cell.traffic["loop"]
    return load_module(os.path.join(cell.dir, "drivers", loop + ".py"),
                       "perfbench_driver_" + loop)


class Cell:
    """A workload of `BENCHMARK.json` with its configuration, traffic mix
    and metrics, all found by name under `root`."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.spec = read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        entry = {c["name"]: c for c in self.spec["configs"]}[
            self.workload["config"]]
        self.config = read_json(os.path.join(root, entry["file"]))
        bench_dir = os.path.join(root, self.spec["paths"][0])
        self.dir = bench_dir
        self.traffic = read_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])

    def _applies(self, metric: dict, reported: set) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves", metric["name"]) in reported

    def end_to_end(self, driver_e2e) -> list:
        out = []
        for m in self.spec["end_to_end"]:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            if m["name"] in ("setup_s", "peak_mem_gib") or \
                    m["name"] in driver_e2e:
                out.append(m)
        return out

    def per_layer(self, e2e_names: set) -> list:
        return [m for m in self.spec["per_layer"]
                if self._applies(m, e2e_names)]

    def limits(self) -> dict:
        path = os.path.join(self.dir, "limits", self.name + ".json")
        return read_json(path) if os.path.exists(path) else {}


class Run:
    """What one run knows: its cell, seed, device, the matrix it built,
    what set-up and the window recorded, and the traced segment."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device):
        import torch

        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.info: dict = {}         # set-up's readings (driver)
        self.window: dict = {}       # the window's readings (driver)
        self.segment: dict = {}      # the traced segment's readings
        self.trace = None            # trace.TraceSummary of the segment
        self.problem = None          # (rows, cols, vals, n), or None

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port's nvcc library already lands in gnnla_tpu_torch/_build/."""
    base = os.path.join(root, ".perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def check_chips(chips: int):
    """The card this run measures on; RefusedError without enough."""
    import torch
    if not torch.cuda.is_available():
        raise RefusedError("no CUDA device: the benchmark measures the "
                           "card and never falls back to the CPU")
    have = torch.cuda.device_count()
    if have < chips:
        raise RefusedError(f"the cell asks for {chips} cards, "
                           f"{have} present")
    return torch.device("cuda", 0)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_process: float, driver_cls=None) -> dict:
    """Set up, measure, trace, judge; the result as a dict (the line).
    `driver_cls` replaces the mix's driver (the control puts the
    reference in the program's place)."""
    import torch
    from perfbench import trace as tracing

    run = Run(cell, seed, seconds, device)
    if driver_cls is None:
        driver_cls = load_driver(cell).Driver
    t0 = time.perf_counter()
    run.problem = build_problem(cell)
    run.info["build_s"] = time.perf_counter() - t0
    drv = driver_cls(run)
    drv.setup()
    run.sync()
    say("set-up: " + json.dumps(run.info))

    # the window: items until `seconds` have passed, each synchronised
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    i = 0
    while True:
        drv.item(i, True)
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    run.window["items"] = i
    run.window["seconds"] = time.perf_counter() - t_start
    e2e = drv.end_to_end()

    if trace:
        n = int(cell.traffic["trace_items"])
        run.trace, moved = tracing.profile_items(
            lambda j: drv.item(i + j, False), n, run.device, drv.counters)
        run.segment = {"items": n, "counters": moved}
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise RefusedError(f"JAX or the JAX package loaded: {found}")

    drv.release()
    checks = drv.judge()
    say(f"setup_s {setup_s!r}; window: " + json.dumps(run.window)
        + "; end to end: " + json.dumps(e2e))
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    if not trace:
        e2e["setup_s"] = setup_s
        e2e["peak_mem_gib"] = peak / GIB
        for m in cell.end_to_end(e2e):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        names = {m["name"] for m in cell.end_to_end(e2e)}
        for m in cell.per_layer(names):
            reader = load_module(
                os.path.join(cell.dir, "metrics", m["name"] + ".py"),
                "perfbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": int(run.window["items_attempted"]),
           "failed": int(run.window["items_failed"]),
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse(argv)
    try:
        cell = Cell(args.workload)
        cache_dirs(cell.root)
        device = check_chips(cell.chips)
        if cell.chips != 1:
            raise RefusedError(f"the cell asks for {cell.chips} cards; "
                               "this harness drives one card a cell")
        out = execute(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_process)
        found = forbidden_modules()
        if found:
            raise RefusedError(f"JAX or the JAX package loaded: {found}")
    except RefusedError as e:
        say(f"perfbench: refused: {e}")
        return 2
    line = json.dumps(out)
    for k, c in out["checks"].items():
        say(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(line, flush=True)
    return 0
