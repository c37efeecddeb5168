"""The readings that the two-grid cell's tol and limits are set from, at
the cell's own size on the card. The benchmark's own runs never run this.

    python3 perfbench/calibrate_twogrid.py cycles --seeds A B ... \
            [--max-cycles 6]
        the port's solve through setup_auto at every cycle count up to
        max-cycles, on the first right-hand side of each seed's pool: the
        true relative residual ||b - A x|| / ||b|| in float64 (the tol
        lies between the readings after n_cycles - 1 and n_cycles cycles),
        x against the reference's cycles in float64, and P and Ac against
        the reference's own P and P^T A P (on a vector)
    python3 perfbench/calibrate_twogrid.py control --seeds A B C \
            [--seconds S]
        whole runs with the control in the program's place: the reference
        computed in bfloat16, the precision below the configuration's
        float32, its own P, Ac and cycle from the port's C/F splitting.
        Each has to come out not correct.

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
from perfbench.generator import rhs_pool  # noqa: E402
from perfbench.reference.sparse import Reference  # noqa: E402

CONTROL_DTYPE = torch.bfloat16
WORKLOAD = "poisson2d_5pt_1024.twogrid"


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def driver_module():
    return harness.load_module(os.path.join(harness.HERE, "drivers",
                                            "twogrid.py"), "cal_twogrid")


def control_driver():
    """The twogrid driver with the reference in bfloat16 in the program's
    place: from the port's C/F splitting (data to the reference, as in
    `judge`) the control builds its own P and Ac, hands that P to the
    check of P, applies its Ac to the seed's vector, and solves and checks
    each solve with its own operators."""
    base = driver_module().Driver

    class Control(base):
        def build(self):
            super().build()
            self.auto = self.check = None
            self.counted = []
            self.ctrl = self.reference(CONTROL_DTYPE)
            self.P_host = self.ctrl.P_coo
            self.Ac_v = self.ctrl.Ac.matvec(self.v)

        def _solve(self, i):
            b = self.pool[i % len(self.pool)]
            return self.ctrl.solve(b, self.n_cycles).float()

        def _check(self, i, x=None):
            b = self.pool[i % len(self.pool)].to(CONTROL_DTYPE)
            x = self.x0 if x is None else x
            r = b - self.ctrl.A.matvec(x)
            return torch.linalg.vector_norm(r.float()).reshape(1)

        def release(self):
            self.ctrl = None

    return Control


def cycles(cell, dev, seeds, max_cycles: int) -> None:
    from gnnla_tpu_torch.utils import program

    run = harness.Run(cell, seeds[0], 1.0, dev)
    run.problem = harness.build_problem(cell)
    drv = driver_module().Driver(run)
    drv.build()
    Ac = drv.auto._stencil.setup.Ac
    emit(workload=cell.name, twogrid_setup_s=run.info["twogrid_setup_s"],
         levels=run.info["levels"], p_kind=run.info["p_kind"],
         ac_offsets=len(getattr(Ac, "offsets", ())),
         stages={k: v["host_s"] for k, v in program.report().items()
                 if k.startswith("tg.")})
    rows, cols, vals, n = run.problem
    spd = Reference(rows, cols, vals, n, dev)
    ref = drv.reference()
    for seed in seeds:
        r = harness.Run(cell, seed, 1.0, dev)
        b = rhs_pool(r, n)[0].neg_()     # handed over as -b
        x_ref = ref.solve(b, drv.n_cycles)
        for k in range(1, max_cycles + 1):
            x = drv.auto.solve(b, drv.x0, n_cycles=k)
            line = dict(seed=seed, cycles=k,
                        true_rel_residual=spd.rel_residual(-b, x))
            if k == drv.n_cycles:
                line["x_rel_err"] = float((x.double() - x_ref).abs().max()
                                          / x_ref.abs().max())
            emit(**line)
    emit(p_rel_err=ref.p_rel_err(drv.P_host, drv.P_shape),
         galerkin_rel_err=ref.galerkin_rel_err(drv.v, drv.Ac_v))


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

    p = argparse.ArgumentParser(prog="perfbench/calibrate_twogrid.py")
    p.add_argument("mode", choices=("cycles", "control"))
    p.add_argument("--workload", default=WORKLOAD)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--max-cycles", type=int, default=6)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.cache_dirs(cell.root)
    dev = harness.check_chips(1)
    if args.mode == "cycles":
        cycles(cell, dev, args.seeds, args.max_cycles)
    else:
        control(cell, dev, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
