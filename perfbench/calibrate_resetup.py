"""The readings that the re-set-up cell's tol and limits are set from, at
the cell's own size on the card. The benchmark's own runs never run this.

    python3 perfbench/calibrate_resetup.py floor --seeds A B ... \
            [--fields 3]
        for the first fields of each seed's pool, the port's set-up and
        solve at every iteration count up to the configuration's
        max_iters: the recurrence residual beside the true residual
        ||b - A_k x|| / ||b|| against the field's float64 A_k (where
        float32 stalls: the tol)
    python3 perfbench/calibrate_resetup.py control --seeds A B C \
            [--seconds S]
        whole runs with the control in the program's place: the plain
        reference computed in bfloat16, the precision below the
        configuration's float32 (unpreconditioned CG on A_k, A_k applied
        for level 0, its own piecewise-constant 3 x 3 aggregation P for
        level 1). Each has to come out not correct.

One JSON object a line on standard output.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.generator import sampler  # noqa: E402
from perfbench.reference.sparse import Reference  # noqa: E402

CONTROL_DTYPE = torch.bfloat16
CG_CAP = 1000   # iterations of the control's CG an item
WORKLOAD = "lognormal2d_5pt_512.resetup"


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def driver_module():
    return harness.load_module(os.path.join(harness.HERE, "drivers",
                                            "resetup.py"), "cal_resetup")


def aggregation_p(grid):
    """A piecewise-constant P of 3 x 3 blocks of cells on `grid`: host
    COO (rows, cols, vals) and its shape."""
    nx, ny = grid
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    mx, my = -(-nx // 3), -(-ny // 3)
    rows = (i * ny + j).reshape(-1)
    cols = ((i // 3) * my + j // 3).reshape(-1)
    return (rows, cols, np.ones(rows.shape[0])), (nx * ny, mx * my)


def control_driver():
    """The resetup driver with the reference in bfloat16 in the program's
    place: each item's solve is the reference's CG on the item's A_k, level
    0 is A_k, level 1 P^T A_k P with the control's own P (handed to the
    Galerkin check as the item's P0)."""
    base = driver_module().Driver

    class Control(base):
        def setup(self):
            run = self.run
            self.build()
            self.p0 = aggregation_p(run.config["grid"])
            (rows, cols, vals), (n, n1) = self.p0
            self.P = Reference(rows, cols, vals, n, run.device,
                               CONTROL_DTYPE)
            self.Pt = Reference(cols, rows, vals, n1, run.device,
                                CONTROL_DTYPE)
            self.cur = None
            t0 = time.perf_counter()
            self.item(0, False)
            self.spacing, self.phase = sampler(
                run, run.seconds / (time.perf_counter() - t0),
                len(self.pool))
            self.start_window()

        def _solve(self, i):
            k = i % len(self.vals32)
            self.cur = Reference(self.rows, self.cols, self.vals64[k],
                                 self.n, self.run.device, CONTROL_DTYPE)
            b = self.pool[i % len(self.pool)]
            x, _ = self.cur.cg(b, tol=self.tol, max_iters=CG_CAP)
            r = torch.linalg.vector_norm(
                (b - self.cur.matvec(x)).float())
            return x.float(), r.reshape(1)

        def applied(self):
            n1 = self.p0[1][1]
            y1 = self.Pt.matvec(self.cur.matvec(self.P.matvec(
                self.v[:n1])))
            return self.cur.matvec(self.v).float(), y1.float(), n1

        def counters(self):
            return {}

        def release(self):
            self.cur = self.P = self.Pt = None

    return Control


def floor(cell, dev, seeds, n_fields: int) -> None:
    from gnnla_tpu_torch.models.krylov import mg_pcg

    mod = driver_module()
    for seed in seeds:
        run = harness.Run(cell, seed, 1.0, dev)
        run.problem = harness.build_problem(cell)
        drv = mod.Driver(run)
        drv.build()
        for k in range(n_fields):
            t0 = time.perf_counter()
            _, mg = drv.hierarchy(k)
            run.sync()
            emit(seed=seed, field=k, setup_s=time.perf_counter() - t0,
                 level_rows=[int(d.numel()) for d in mg.diags])
            b = drv.pool[k]
            A = Reference(drv.rows, drv.cols, drv.vals64[k], drv.n, dev)
            for it in range(1, drv.max_iters + 1):
                x, hist = mg_pcg(mg, b, drv.x0, n_iters=it, **drv.pcg)
                rec = float(hist[-1]) / float(drv.bnorm[k])
                emit(seed=seed, field=k, iters=it, recurrence=rec,
                     true=A.rel_residual(b, x))
                if rec < 0.01 * drv.tol:
                    break


def control(cell, dev, seeds, seconds: float) -> list:
    """Whole runs with the control in the program's place; their lines."""
    drv = control_driver()
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

    p = argparse.ArgumentParser(prog="perfbench/calibrate_resetup.py")
    p.add_argument("mode", choices=("floor", "control"))
    p.add_argument("--workload", default=WORKLOAD)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--fields", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.cache_dirs(cell.root)
    dev = harness.check_chips(1)
    if args.mode == "floor":
        floor(cell, dev, args.seeds, args.fields)
    else:
        control(cell, dev, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
