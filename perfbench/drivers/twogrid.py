"""The `twogrid` loop: a user of the paper's two-grid cycle with one
operator and a new right-hand side each step, one solve in flight (a
closed loop).

Set-up hands the port the configuration's operator in the reference's
sign convention, -A (diagonal -4 for the SPD 5-point Laplacian A the
problem builds), and builds the solver through the entry a user calls,
`setup_auto` (classical strength, CLJP splitting, direct interpolation,
Galerkin product; timed as `tg_setup_s`'s stages), which on a square grid
picks the "stencil" layout: the fine level on kernel K4, Ac on K1 and P on
K2 on the card. Each right-hand side b of the pool (made on the device
from the seed) is handed over as -b, once, at set-up: -A x = -b has the
same x. A solve is `auto.solve(-b, x0, n_cycles)` from x0 = 0.

A solve's latency runs from the hand-over of b until x is ready on the
device (synchronised). After the latency stop the driver enqueues the
solve's own check, one K4 residual call on the fine grid and its norm,
and reads the norms at the window's end: a solve whose ||b - A x|| is
above tol * ||b|| failed, counts as not done and as missing every latency
limit. The plain reference takes A and the set-up's C/F splitting as
data and builds its own strength, direct interpolation, P and P^T A P in
float64. `correct` holds the set-up's P to the reference's entry by
entry, the sampled solves' true residual, read in float64, to tol, their
x to the reference cycle's x on the same b, the set-up's Ac as the cycle
applies it (on K1 on the card) to the reference's P^T A P on a vector
from the seed, and every solve to tol.

On the card the cycle has to run on the port's kernels (Ac a
`DiaKernelOperator`, P a `RectStreamOperator`): a set-up that leaves
either on the plain path is refused at set-up, not timed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.drivers.solve import NO_SAMPLE, UNMET_MS
from perfbench.generator import rhs_pool, sampler
from perfbench.reference.sparse import Reference
from perfbench.reference.twogrid import TwoGrid
from perfbench.trace import span

CYCLE_KEYS = ("n_pre", "n_post", "omega", "coarse_deg", "coarse_c",
              "coarse_d")


class Driver:
    def __init__(self, run):
        self.run = run
        tg = dict(run.config["twogrid"])
        self.n_cycles = int(tg.pop("n_cycles"))
        self.tol = float(tg.pop("tol"))
        self.cycle_kw = {k: tg.pop(k) for k in CYCLE_KEYS}
        self.amg = tg  # theta, splitting, seed
        self.grid = tuple(int(g) for g in run.config["grid"])
        self.t_init = time.perf_counter()

    def build(self) -> None:
        """The solver (its host seconds `twogrid_setup_s` and its stages'
        `stages_s` in the set-up's record), its check, the right-hand sides
        and x0."""
        from gnnla_tpu_torch.models.vcycle import setup_auto
        from gnnla_tpu_torch.ops.sparse import SparseOperator
        from gnnla_tpu_torch.ops.stencil_kernel import make_stencil_residual
        from gnnla_tpu_torch.utils import program

        run, dev = self.run, self.run.device
        rows, cols, vals, n = run.problem
        t0 = time.perf_counter()
        A = SparseOperator.from_coo(rows, cols, -vals, (n, n),
                                    dtype=torch.float32, coalesce=False,
                                    device=dev)
        run.sync()
        run.info["to_card_s"] = time.perf_counter() - t0  # the CUDA context
        t0 = time.perf_counter()
        self.auto = setup_auto(A, **self.amg, **self.cycle_kw)
        run.sync()
        run.info["twogrid_setup_s"] = time.perf_counter() - t0
        if self.auto.layout != "stencil":
            raise RuntimeError(f"setup_auto chose {self.auto.layout!r}, not "
                               f"the stencil layout: {self.auto.why}")
        plain = self.auto.setup
        sv = self.auto._stencil
        Ac, P = sv.setup.Ac, sv.setup.P
        kinds = (type(Ac).__name__, type(P).__name__)
        if dev.type == "cuda" and \
                kinds != ("DiaKernelOperator", "RectStreamOperator"):
            raise RuntimeError(f"the stencil leg's Ac and P are {kinds}, "
                               "not on K1 and K2")
        self.check = make_stencil_residual(plain.A, self.grid)
        # the set-up's C/F splitting and P as host data, for the reference
        # after release()
        self.coarse = plain.coarse_flags.cpu().numpy()
        self.P_host, self.P_shape = plain.P.host_coo(), plain.P.shape
        self.nc = plain.P.n_cols
        self.k4 = sv.kernel_calls() + [self.check._call]
        run.info["levels"] = [
            {"n": n, "nnz": plain.A.nnz, "kind": "k4"},
            {"n": self.nc, "nnz": plain.Ac.nnz,
             "kind": type(Ac).__name__}]
        run.info["k4_calls"] = [
            {"counter": f"k4_call_{j}", "K": int(c.taps.shape[0]),
             "n": int(c.taps[0].numel()),
             "tap_bytes": int(c.taps.element_size()), "mode": c.mode,
             "n_steps": c.n_steps}
            for j, c in enumerate(self.k4)]
        # launch counters: K4's calls, and on the card K1 on Ac and K2 on
        # P (fwd) and P^T (bwd)
        self.counted = [(f"k4_call_{j}", c) for j, c in enumerate(self.k4)]
        if dev.type == "cuda":
            self.counted += [("k1_level_1", Ac), ("k2_p", P.fwd),
                             ("k2_pt", P.bwd)]
        run.info["p_kind"] = type(P).__name__
        # the host seconds of set-up's stages (the classical set-up, the
        # stencil cycle's taps and layouts)
        run.info["stages_s"] = {k: v["host_s"] for k, v in
                                program.report().items()
                                if k.startswith("tg.") and v["calls"]}
        del A, plain

        t0 = time.perf_counter()
        self.pool = rhs_pool(run, n)
        self.bnorm = torch.stack([torch.linalg.vector_norm(b.double())
                                  for b in self.pool]).cpu().numpy()
        self.pool.neg_()  # the hand-over: the port solves -A x = -b
        self.x0 = torch.zeros(n, device=dev, dtype=torch.float32)
        # Ac as the cycle applies it, on a vector from the seed
        self.v = self.pool[-1, :self.nc].clone()
        self.Ac_v = Ac.matvec(self.v)
        run.sync()
        run.info["pool_s"] = time.perf_counter() - t0

    def setup(self) -> None:
        run = self.run
        self.build()
        # the first call captures the cycle's program; the check's shape
        t0 = time.perf_counter()
        self._solve(0)
        self._check(0)
        run.sync()
        run.info["first_solve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reps = int(run.traffic["warmup_replays"])
        for j in range(reps):
            self._solve(j)
            run.sync()
        self.est = (time.perf_counter() - t0) / reps
        run.info["solve_s_est"] = self.est
        self.spacing, self.phase = sampler(run, run.seconds / self.est,
                                           len(self.pool))
        self.start_window()
        run.info["driver_s"] = time.perf_counter() - self.t_init

    def start_window(self) -> None:
        """Sample buffers and the checks' norms made before the window, so
        that its memory is the same whatever it keeps; empty records."""
        run = self.run
        self.buf = torch.empty((int(run.traffic["samples"]),
                                self.pool.shape[1]), device=run.device)
        self.norms = torch.empty(int(1.5 * run.seconds / self.est) + 256,
                                 device=run.device)
        self.kept = []
        self.lat, self.starts = [], []

    def _solve(self, i: int) -> torch.Tensor:
        return self.auto.solve(self.pool[i % len(self.pool)], self.x0,
                               n_cycles=self.n_cycles)

    def _check(self, i: int, x=None) -> torch.Tensor:
        """||b - A x|| of a solve on the device (K4 on the fine grid)."""
        b = self.pool[i % len(self.pool)].reshape(self.grid)
        x = self.x0 if x is None else x
        r = self.check.run(b, x.reshape(self.grid))
        return torch.linalg.vector_norm(r).reshape(1)

    def counters(self) -> dict:
        return {name: obj.launches for name, obj in self.counted}

    def item(self, i: int, keep: bool) -> None:
        with span("solve"):
            t0 = time.perf_counter()
            x = self._solve(i)
            with span("sync"):
                self.run.sync()
            t1 = time.perf_counter()
        with span("check"):
            norm = self._check(i, x)
        if not keep:
            return
        j = len(self.lat)
        if j == len(self.norms):  # more solves than the estimate allowed
            self.norms = torch.cat([self.norms, torch.empty_like(self.norms)])
        self.norms[j:j + 1].copy_(norm)
        self.lat.append(t1 - t0)
        self.starts.append(t0)
        if i % self.spacing == self.phase and \
                len(self.kept) < self.buf.shape[0]:
            with span("sample"):
                self.buf[len(self.kept)].copy_(x)
            self.kept.append(i)

    def end_to_end(self) -> dict:
        w = self.run.window
        n = len(self.lat)
        norms = self.norms[:n].double().cpu().numpy()
        bnorm = self.bnorm[np.arange(n) % len(self.pool)]
        ok = np.isfinite(norms) & (norms <= self.tol * bnorm)
        lat_ms = np.where(ok, np.asarray(self.lat) * 1e3, np.inf)
        p95 = float(np.sort(lat_ms)[math.ceil(0.95 * n) - 1])
        w["items_attempted"] = n
        w["items_failed"] = int(n - ok.sum())
        w["solve_s_mean"] = float(np.mean(self.lat))
        w["check_rel_residual_max"] = float(np.max(norms / bnorm))
        w["solve_ms_quartiles"] = [float(v) for v in np.percentile(
            np.asarray(self.lat) * 1e3, [0, 5, 25, 50, 75, 95, 100])]
        # the host's time between a solve's latency stop and the next
        # solve's start (its check, the records, the loop)
        out = np.diff(self.starts) - np.asarray(self.lat[:-1])
        if out.size:
            w["outside_s"] = float(out.sum())
            w["outside_ms_quantiles"] = [float(v) for v in np.percentile(
                out * 1e3, [0, 50, 95, 99, 100])]
            w["outside_over_5ms"] = int((out > 5e-3).sum())
        return {"solves_per_s": float(ok.sum()) / w["seconds"],
                "solve_ms_p95": p95 if math.isfinite(p95) else UNMET_MS}

    def release(self) -> None:
        self.auto = self.check = self.k4 = self.counted = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64) -> TwoGrid:
        """The reference set-up and cycle on -A (the reference's
        convention) and the set-up's C/F splitting, in `dtype`."""
        rows, cols, vals, n = self.run.problem
        return TwoGrid((rows, cols, -vals), self.coarse, n, self.run.device,
                       dtype, theta=self.amg["theta"], **self.cycle_kw)

    def judge(self) -> dict:
        rows, cols, vals, n = self.run.problem
        lim = self.run.cell.limits()
        spd = Reference(rows, cols, vals, n, self.run.device)
        ref = self.reference()
        res, err = [], []
        for j, i in enumerate(self.kept):
            b = self.pool[i % len(self.pool)]          # -b, as handed over
            x = self.buf[j]
            res.append(spd.rel_residual(-b, x))        # ||b - A x|| / ||b||
            x_ref = ref.solve(b, self.n_cycles)
            err.append(float((x.double() - x_ref).abs().max())
                       / max(float(x_ref.abs().max()), 1e-300))
        return {
            "p_rel_err": (ref.p_rel_err(self.P_host, self.P_shape),
                          lim["p_rel_err"]["limit"]),
            "true_rel_residual": (max(res) if res else NO_SAMPLE, self.tol),
            "x_rel_err": (max(err) if err else NO_SAMPLE,
                          lim["x_rel_err"]["limit"]),
            "galerkin_rel_err": (ref.galerkin_rel_err(self.v, self.Ac_v),
                                 lim["galerkin_rel_err"]["limit"]),
            "unconverged_solves": (self.run.window["items_failed"], 0)}
