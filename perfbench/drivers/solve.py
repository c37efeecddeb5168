"""The `solve` loop: a time-stepping user with one operator and a new
right-hand side each step, one solve in flight (a closed loop).

Set-up builds the port's SA hierarchy with every banded level on kernel
K1 (`setup_sa_multigrid`, `setup_with_dia_multigrid(kernel=True)`), a
pool of right-hand sides on the device from the seed, and the iteration
count: a few warm-up solves run to the configuration's `max_iters`, and
every timed solve runs the largest count at which the port's own
residual history fell under tol * ||b||, plus one. The timed entry is
`program(mg_pcg)` (one captured CUDA graph a solve), x0 = 0.

A solve's latency runs from the hand-over of b until x is ready on the
device (synchronised). A solve whose own residual history ends above
tol * ||b|| failed: it counts as not done, and as missing every latency
limit. `correct` holds the sampled solves' true residual ||b - A x|| /
||b||, in float64 by the plain reference, to the configuration's tol.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.generator import rhs_pool, sampler
from perfbench.reference.sparse import Reference
from perfbench.trace import span

# the reading of a check with no sample to read: fails any limit
NO_SAMPLE = 1e300

# a p95 that a failed solve makes infinite is printed as this many ms
UNMET_MS = 1e30


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.pcg = dict(self.cfg["pcg"])
        self.tol = float(self.pcg.pop("tol"))
        self.max_iters = int(self.pcg.pop("max_iters"))

    def build(self) -> None:
        """The hierarchy (timed as `amg_setup_s`), the right-hand sides
        and x0."""
        from gnnla_tpu_torch.models.multigrid import (
            setup_sa_multigrid, setup_with_dia_multigrid)
        from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
        from gnnla_tpu_torch.ops.sparse import SparseOperator

        run, dev = self.run, self.run.device
        rows, cols, vals, n = run.problem
        amg = self.cfg["amg"]
        A = SparseOperator.from_coo(rows, cols, vals, (n, n),
                                    dtype=torch.float32, coalesce=False,
                                    device=dev)
        t0 = time.perf_counter()
        mg = setup_sa_multigrid(A, theta=amg["theta"], seed=amg["seed"])
        self.mg = setup_with_dia_multigrid(mg, max_offsets=amg["max_offsets"],
                                           kernel=True)
        run.sync()
        run.info["amg_setup_s"] = time.perf_counter() - t0
        del A, mg
        self.k1 = [(lvl, op) for lvl, op in enumerate(self.mg.As)
                   if isinstance(op, DiaKernelOperator)]
        run.info["levels"] = [
            {"n": op.n_rows, "nnz": op.nnz,
             "kind": "k1" if isinstance(op, DiaKernelOperator) else "coo"}
            for op in self.mg.As]
        self.rhs(n)

    def rhs(self, n: int) -> None:
        """The pool of right-hand sides, their norms, and x0."""
        self.pool = rhs_pool(self.run, n)
        self.bnorm = torch.stack([torch.linalg.vector_norm(b.double())
                                  for b in self.pool]).cpu().numpy()
        self.x0 = torch.zeros(n, device=self.run.device, dtype=torch.float32)

    def setup(self) -> None:
        from gnnla_tpu_torch.models.krylov import mg_pcg
        from gnnla_tpu_torch.utils.program import program

        run = self.run
        self.build()

        # the iteration count, from eager solves of the first pool vectors
        counts = []
        for j in range(int(run.traffic["warmup_solves"])):
            _, hist = mg_pcg(self.mg, self.pool[j], self.x0,
                             n_iters=self.max_iters, **self.pcg)
            rel = hist.double().cpu().numpy() / self.bnorm[j]
            hit = np.flatnonzero(rel < self.tol)
            if hit.size == 0:
                raise RuntimeError(
                    f"warm-up solve {j} did not reach tol {self.tol} in "
                    f"{self.max_iters} iterations (last {rel[-1]:.3e})")
            counts.append(int(hit[0]) + 1)
        self.iters = max(counts) + 1
        run.info["warmup_iters"] = counts
        run.info["pcg_iters"] = self.iters

        # the timed entry: capture, then replays to estimate a solve
        self.prog = program(mg_pcg)
        self._solve(0)
        run.sync()
        t0 = time.perf_counter()
        reps = int(run.traffic["warmup_replays"])
        for j in range(reps):
            self._solve(j)
            run.sync()
        est = (time.perf_counter() - t0) / reps
        run.info["solve_s_est"] = est
        self.spacing, self.phase = sampler(run, run.seconds / est,
                                           len(self.pool))
        self.start_window()

    def start_window(self) -> None:
        """Sample buffers made before the window, so that its memory is
        the same whatever it keeps; empty records."""
        self.buf = torch.empty((int(self.run.traffic["samples"]),
                                self.pool.shape[1]), device=self.run.device)
        self.kept = []
        self.lat, self.last = [], []

    def _solve(self, i: int):
        return self.prog(self.mg, self.pool[i % len(self.pool)], self.x0,
                         n_iters=self.iters, **self.pcg)

    def counters(self) -> dict:
        return {f"k1_level_{lvl}": op.launches for lvl, op in self.k1}

    def item(self, i: int, keep: bool) -> None:
        with span("solve"):
            t0 = time.perf_counter()
            x, hist = self._solve(i)
            with span("sync"):
                self.run.sync()
            t1 = time.perf_counter()
        if not keep:
            return
        self.lat.append(t1 - t0)
        self.last.append(hist[-1:])
        if i % self.spacing == self.phase and \
                len(self.kept) < self.buf.shape[0]:
            with span("sample"):
                self.buf[len(self.kept)].copy_(x)
            self.kept.append(i)

    def end_to_end(self) -> dict:
        w = self.run.window
        n = len(self.lat)
        last = torch.cat(self.last).double().cpu().numpy()
        want = self.tol * self.bnorm[np.arange(n) % len(self.pool)]
        ok = np.isfinite(last) & (last < want)
        lat_ms = np.where(ok, np.asarray(self.lat) * 1e3, np.inf)
        p95 = float(np.sort(lat_ms)[math.ceil(0.95 * n) - 1])
        w["items_attempted"] = n
        w["items_failed"] = int(n - ok.sum())
        w["solve_s_mean"] = float(np.mean(self.lat))
        w["solve_ms_quartiles"] = [float(v) for v in np.percentile(
            np.asarray(self.lat) * 1e3, [0, 5, 25, 50, 75, 95, 100])]
        return {"solves_per_s": float(ok.sum()) / w["seconds"],
                "solve_ms_p95": p95 if math.isfinite(p95) else UNMET_MS}

    def release(self) -> None:
        self.prog = self.mg = self.k1 = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> dict:
        rows, cols, vals, n = self.run.problem
        ref = Reference(rows, cols, vals, n, self.run.device)
        res = [ref.rel_residual(self.pool[i % len(self.pool)], self.buf[j])
               for j, i in enumerate(self.kept)]
        return {"true_rel_residual": (max(res) if res else NO_SAMPLE,
                                      self.tol),
                "unconverged_solves": (self.run.window["items_failed"], 0)}
