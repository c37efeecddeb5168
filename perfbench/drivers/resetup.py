"""The `resetup` loop: a user who changes the operator between solves (a
multilevel Monte Carlo sampler of a diffusion problem with a random
coefficient, a Picard or Newton iteration), one item in flight (a closed
loop).

Set-up draws a pool of coefficient fields on the host in float64 from the
seed (`problems/lognormal_fv.py`), keeps each operator's values in float64
for the checks and in float32 for the hand-over, and makes a pool of
right-hand sides on the device as the `solve` loop does. Every field's
hierarchy is set up and solved once eagerly to the configuration's
`max_iters`; every timed solve runs the largest count at which such a
solve's residual history fell under tol * ||b||, plus one.

One item, for field i mod F and right-hand side i mod P, timed from the
hand-over of the field's values and b until x is ready (synchronised):

1. `SparseOperator.from_coo` of the shared pattern and the field's values
   on the card;
2. `setup_sa_multigrid` (the configuration's theta and seed);
3. `setup_with_dia_multigrid(kernel=True)`: K1 where `to_dia` takes a
   level, K2 on the others and on every P;
4. one call of the one `program(mg_pcg)` every item shares, x0 = 0: a new
   hierarchy, so a warm-up and a capture;
5. dropping the previous item's hierarchy (the driver holds no other).

A sampler runs thousands of items, so device memory may not grow with
them: set-up reads the memory allocated after each of its items through
the program (the collector run, that item's hierarchy alive) and refuses
a port whose items leave more than half of what the first left held (a
program that keeps every hierarchy adds one each; at this size it runs
80 GB out within about a thousand items).

The window, sampling, latency and `end_to_end` are the `solve` loop's
(`drivers/solve.py`): a solve whose own residual history ends above
tol * ||b|| failed, counts as not done and misses every latency limit.
After a sampled item's latency stop the driver keeps x, its level 0 and
level 1 applied (as the solve applies them) to a vector from the seed, and
its P0 on the host. `correct` holds, against each sampled item's own
float64 operator A_k, the true residual ||b - A_k x|| / ||b|| to tol, level
0 to A_k, and level 1 to P0^T A_k P0 (the cell's limits file).
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from perfbench.generator import host_rng, sampler
from perfbench.harness import load_module
from perfbench.reference.sparse import Reference
from perfbench.trace import span

HERE = os.path.dirname(os.path.abspath(__file__))
_solve = load_module(os.path.join(HERE, "solve.py"),
                     "perfbench_resetup_base")
_fields = load_module(os.path.join(os.path.dirname(HERE), "problems",
                                   "lognormal_fv.py"),
                      "perfbench_resetup_fields")
NO_SAMPLE = _solve.NO_SAMPLE
COUNTERS = ("captures", "replays", "released")


def held_bytes(device):
    """Device memory allocated once the collector has run; None off the
    card."""
    if device.type != "cuda":
        return None
    gc.collect()
    return torch.cuda.memory_allocated(device)


def refuse_growth(base: int, held: list) -> None:
    """Refuse items that leave memory held: `held` is the memory allocated
    after each item, `base` before the first."""
    first = held[0] - base
    grew = (held[-1] - held[0]) / max(len(held) - 1, 1)
    if grew > first / 2:
        raise RuntimeError(
            f"each item leaves {grew / 2**20:.1f} MiB more device memory "
            f"held (the first left {first / 2**20:.1f} MiB): the program "
            "keeps the hierarchies this loop dropped, so a sampler of "
            "this deployment's length runs out of device memory")


def rel_err(y: torch.Tensor, want: torch.Tensor) -> float:
    """max|y - want| / max|want|, in float64."""
    return float((y.double() - want).abs().max()) / max(
        float(want.abs().max()), 1e-300)


class Driver(_solve.Driver):
    def build(self) -> None:
        """The pattern, the fields' values, the right-hand sides, x0 and
        the checks' vector."""
        run = self.run
        self.rows, self.cols, _, self.n = run.problem
        t0 = time.perf_counter()
        rng = host_rng(run.seed)
        self.vals64 = [_fields.sample(run.config, rng)
                       for _ in range(int(run.traffic["fields_pool"]))]
        self.vals32 = [v.astype(np.float32) for v in self.vals64]
        run.info["fields_s"] = time.perf_counter() - t0
        self.rhs(self.n)
        self.v = self.pool[-1].clone()
        self.mg = self.p0 = None

    def hierarchy(self, k: int):
        """Steps 1-3 of an item on field k: (the SA set-up, the solve's
        set-up on K1 and K2)."""
        from gnnla_tpu_torch.models.multigrid import (
            setup_sa_multigrid, setup_with_dia_multigrid)
        from gnnla_tpu_torch.ops.sparse import SparseOperator

        amg = self.cfg["amg"]
        A = SparseOperator.from_coo(self.rows, self.cols, self.vals32[k],
                                    (self.n, self.n), dtype=torch.float32,
                                    coalesce=False, device=self.run.device)
        sa = setup_sa_multigrid(A, theta=amg["theta"], seed=amg["seed"])
        return sa, setup_with_dia_multigrid(
            sa, max_offsets=amg["max_offsets"], kernel=True)

    def setup(self) -> None:
        from gnnla_tpu_torch.models.krylov import mg_pcg
        from gnnla_tpu_torch.utils.program import program

        run = self.run
        self.build()

        # every field eagerly: the iteration count, and every shape warm
        t0 = time.perf_counter()
        counts, levels = [], []
        for k in range(len(self.vals32)):
            sa, mg = self.hierarchy(k)
            j = k % len(self.pool)
            _, hist = mg_pcg(mg, self.pool[j], self.x0,
                             n_iters=self.max_iters, **self.pcg)
            rel = hist.double().cpu().numpy() / self.bnorm[j]
            hit = np.flatnonzero(rel < self.tol)
            if hit.size == 0:
                raise RuntimeError(
                    f"warm-up solve of field {k} did not reach tol "
                    f"{self.tol} in {self.max_iters} iterations (last "
                    f"{rel[-1]:.3e})")
            counts.append(int(hit[0]) + 1)
            levels.append([int(d.numel()) for d in mg.diags])
        del sa, mg
        self.iters = max(counts) + 1
        run.info["warmup_s"] = time.perf_counter() - t0
        run.info["warmup_iters"] = counts
        run.info["pcg_iters"] = self.iters
        run.info["level_rows"] = levels

        # the timed entry, and items through it to estimate an item and
        # to hold memory flat
        self.prog = program(mg_pcg)
        base = held_bytes(run.device)
        took, held = 0.0, []
        reps = int(run.traffic["warmup_items"])
        for j in range(reps):
            t0 = time.perf_counter()
            self.item(j, False)
            took += time.perf_counter() - t0
            held.append(held_bytes(run.device))
        est = took / reps
        run.info["item_s_est"] = est
        if base is not None:
            run.info["held_bytes"] = [base] + held
            refuse_growth(base, held)
        self.spacing, self.phase = sampler(run, run.seconds / est,
                                           len(self.pool))
        self.start_window()

    def start_window(self) -> None:
        super().start_window()
        self.y0 = torch.empty_like(self.buf)
        self.y1 = torch.empty_like(self.buf)
        self.sampled = []

    def _solve(self, i: int):
        """Steps 1-5 of item i."""
        k = i % len(self.vals32)
        sa, mg = self.hierarchy(k)
        out = self.prog(mg, self.pool[i % len(self.pool)], self.x0,
                        n_iters=self.iters, **self.pcg)
        p0 = sa.Ps[0] if sa.Ps else None
        self.mg = mg    # the previous item's hierarchy is dropped here
        self.p0 = None if p0 is None else (p0.host_coo(), p0.shape)
        return out

    def applied(self):
        """The current item's level 0 and level 1 applied to the checks'
        vector (its first n1 entries on level 1), as the solve applies
        them; (y0, y1, n1)."""
        A0, A1 = self.mg.As[0], self.mg.As[1]
        n1 = int(self.mg.diags[1].numel())
        return A0.matvec(self.v), A1.matvec(self.v[:n1]), n1

    def item(self, i: int, keep: bool) -> None:
        n_kept = len(self.kept) if keep else 0
        super().item(i, keep)
        if keep and len(self.kept) > n_kept:
            j = n_kept
            with span("sample"):
                y0, y1, n1 = self.applied()
                self.y0[j].copy_(y0)
                self.y1[j, :n1].copy_(y1)
            self.sampled.append((i % len(self.vals32), n1, self.p0))

    def counters(self) -> dict:
        return {name: getattr(self.prog, name) for name in COUNTERS
                if hasattr(self.prog, name)}

    def release(self) -> None:
        live = getattr(self.prog, "live", None)
        if live is not None:
            self.run.info["live_graphs"] = live
        self.mg = self.p0 = None
        super().release()

    def judge(self) -> dict:
        dev, n = self.run.device, self.n
        lim = self.run.cell.limits()
        v = self.v.double()
        res, a0, gal = [], [], []
        for j, (i, (k, n1, p0)) in enumerate(zip(self.kept, self.sampled)):
            A = Reference(self.rows, self.cols, self.vals64[k], n, dev)
            res.append(A.rel_residual(self.pool[i % len(self.pool)],
                                      self.buf[j]))
            a0.append(rel_err(self.y0[j], A.matvec(v)))
            if p0 is None or p0[1] != (n, n1):
                gal.append(NO_SAMPLE)   # not this item's own P0
                continue
            (pr, pc, pv), _ = p0
            P = Reference(pr, pc, pv, n, dev)
            Pt = Reference(pc, pr, pv, n1, dev)
            gal.append(rel_err(self.y1[j, :n1],
                               Pt.matvec(A.matvec(P.matvec(v[:n1])))))

        def worst(vals):
            return max(vals) if vals else NO_SAMPLE

        return {"res_rel": (worst(res), self.tol),
                "a0_rel_err": (worst(a0), lim["a0_rel_err"]["limit"]),
                "galerkin_rel_err": (worst(gal),
                                     lim["galerkin_rel_err"]["limit"])}
