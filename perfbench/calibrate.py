"""The readings that the limits of `correct` are set from, at a cell's own
size on the card. The benchmark's own runs never run this.

    python3 perfbench/calibrate.py floor --workload <solve cell> [--rhs 3]
        the port's solve at every iteration count up to the config's
        max_iters: the recurrence residual beside the true residual
        ||b - A x|| / ||b|| in float64 (where float32 stalls: the tol)
    python3 perfbench/calibrate.py control --workload <cell> --seeds A B C \
            [--seconds S]
        whole runs with the control in the program's place: the plain
        reference computed in bfloat16, the precision below the
        configuration's float32. Each has to come out not correct.

One JSON object a line on standard output.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.generator import rhs_pool, sampler  # noqa: E402
from perfbench.reference.sparse import Reference  # noqa: E402

CONTROL_DTYPE = torch.bfloat16
CG_CAP = 50000  # iterations the float64 reference may take


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def solve_control(cap: int):
    """The solve driver with the reference's CG in bfloat16 in place of
    the port's solve, each solve capped at `cap` iterations (where the
    float64 reference converges at this size)."""
    solve = harness.load_module(os.path.join(harness.HERE, "drivers",
                                             "solve.py"), "cal_solve")

    class Control(solve.Driver):
        def setup(self):
            rows, cols, vals, n = self.run.problem
            self.rhs(n)
            self.ref = Reference(rows, cols, vals, n, self.run.device,
                                 CONTROL_DTYPE)
            t0 = time.perf_counter()
            self._solve(0)
            self.spacing, self.phase = sampler(
                self.run, self.run.seconds / (time.perf_counter() - t0),
                len(self.pool))
            self.start_window()

        def _solve(self, i):
            b = self.pool[i % len(self.pool)]
            x, _ = self.ref.cg(b, tol=self.tol, max_iters=cap)
            r = torch.linalg.vector_norm((b - self.ref.matvec(x)).float())
            return x.float(), r.reshape(1)

        def release(self):
            self.ref = None

    return Control


def matvec_control():
    """The matvec driver with the reference's y = A x in bfloat16 in
    place of the port's operator."""
    matvec = harness.load_module(os.path.join(harness.HERE, "drivers",
                                              "matvec.py"), "cal_matvec")

    class Control(matvec.Driver):
        def setup(self):
            rows, cols, vals, n = self.run.problem
            self.nnz = int(rows.shape[0])
            self.op = Reference(rows, cols, vals, n, self.run.device,
                                CONTROL_DTYPE)
            self.pool = rhs_pool(self.run, n)
            self.buf = torch.empty((int(self.run.traffic["samples"]), n),
                                   device=self.run.device)
            self.kept = []
            self.spacing, self.phase = 1, -1
            t0 = time.perf_counter()
            self.item(0, False)
            est = (time.perf_counter() - t0) / self.chunk
            self.spacing, self.phase = sampler(
                self.run, self.run.seconds / est, len(self.pool))

    return Control


def floor(cell, dev, n_rhs: int) -> None:
    from gnnla_tpu_torch.models.krylov import mg_pcg

    run = harness.Run(cell, 0, 1.0, dev)
    run.problem = harness.build_problem(cell)
    solve = harness.load_driver(cell)
    drv = solve.Driver(run)
    drv.build()
    emit(workload=cell.name, amg_setup_s=run.info["amg_setup_s"],
         levels=run.info["levels"])
    ref = Reference(*run.problem, dev)
    for j in range(n_rhs):
        b = drv.pool[j]
        for k in range(1, drv.max_iters + 1):
            x, hist = mg_pcg(drv.mg, b, drv.x0, n_iters=k, **drv.pcg)
            emit(rhs=j, iters=k,
                 recurrence=float(hist[-1]) / float(drv.bnorm[j]),
                 true=ref.rel_residual(b, x))


def control(cell, dev, seeds, seconds: float) -> list:
    """Whole runs with the control in the program's place; their lines."""
    if cell.traffic["loop"] == "solve":
        run = harness.Run(cell, seeds[0], 1.0, dev)
        run.problem = harness.build_problem(cell)
        ref = Reference(*run.problem, dev)
        b = rhs_pool(run, run.problem[3])[0]
        tol = float(cell.config["pcg"]["tol"])
        t0 = time.perf_counter()
        x, its = ref.cg(b, tol=tol, max_iters=CG_CAP)
        emit(workload=cell.name, reference="float64", cg_iters=its,
             seconds=time.perf_counter() - t0,
             true_rel_residual=ref.rel_residual(b, x), tol=tol)
        del ref, x, b
        drv = solve_control(its)
    else:
        drv = matvec_control()
    outs = []
    for seed in seeds:
        out = harness.execute(cell, seed, seconds, False, dev,
                              time.perf_counter(), driver_cls=drv)
        emit(workload=cell.name, control=str(CONTROL_DTYPE), seed=seed,
             correct=out["correct"], attempted=out["attempted"],
             checks=out["checks"])
        outs.append(out)
    return outs


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    p.add_argument("mode", choices=("floor", "control"))
    p.add_argument("--workload", required=True)
    p.add_argument("--rhs", type=int, default=3)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.cache_dirs(cell.root)
    dev = harness.check_chips(1)   # the control needs one card at any size
    if args.mode == "floor":
        floor(cell, dev, args.rhs)
    else:
        control(cell, dev, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
