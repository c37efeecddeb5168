"""The `matvec` loop: closed-loop graph-network message passing, y = A x,
on the operator that the port's own layout choice gives the matrix:
`to_dia` and `dia_kernel_operator` (kernel K1), called eagerly as a user
calls `matvec`. x cycles through a pool of vectors from the seed, larger
than the L2 cache; one item is `chunk` applies and one synchronisation,
so the host clock spans many applies.

`correct` holds the sampled applies' y to the float64 plain reference:
max |y - A x| / max |A x| against the cell's limit in
`limits/<cell>.json`, set from the readings of the program and of the
control (no limit there: the check fails).
"""

from __future__ import annotations

import time

import torch

from perfbench.generator import rhs_pool, sampler
from perfbench.reference.sparse import Reference
from perfbench.trace import span

# the reading of a check with no sample to read: fails any limit
NO_SAMPLE = 1e300


class Driver:
    def __init__(self, run):
        self.run = run
        self.chunk = int(run.traffic["chunk"])

    def setup(self) -> None:
        from gnnla_tpu_torch.ops.dia import to_dia
        from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator
        from gnnla_tpu_torch.ops.sparse import SparseOperator

        run = self.run
        rows, cols, vals, n = run.problem
        self.nnz = int(rows.shape[0])
        A = SparseOperator.from_coo(rows, cols, vals, (n, n),
                                    dtype=torch.float32, coalesce=False,
                                    device=run.device)
        self.op = dia_kernel_operator(to_dia(A))
        del A
        run.info["levels"] = [{"n": n, "nnz": self.nnz, "kind": "k1"}]
        self.pool = rhs_pool(run, n)
        self.warm_up()

    def warm_up(self) -> None:
        """Every shape of the window, then the sampling from the rate."""
        run = self.run
        self.buf = torch.empty((int(run.traffic["samples"]),
                                self.pool.shape[1]), device=run.device)
        self.spacing, self.phase = 1, -1   # no sample during the warm-up
        self.kept = []
        reps = int(run.traffic["warmup_chunks"])
        for j in range(reps):
            self.item(j, False)
        t0 = time.perf_counter()
        for j in range(reps):
            self.item(j, False)
        est = (time.perf_counter() - t0) / (reps * self.chunk)
        run.info["apply_s_est"] = est
        self.spacing, self.phase = sampler(run, run.seconds / est,
                                           len(self.pool))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.matvec(x)

    def counters(self) -> dict:
        return {"k1_level_0": self.op.launches}

    def item(self, i: int, keep: bool) -> None:
        p = len(self.pool)
        with span("applies"):
            for j in range(i * self.chunk, (i + 1) * self.chunk):
                y = self.apply(self.pool[j % p])
                if keep and j % self.spacing == self.phase and \
                        len(self.kept) < self.buf.shape[0]:
                    self.buf[len(self.kept)].copy_(y)
                    self.kept.append(j)
        with span("sync"):
            self.run.sync()

    def end_to_end(self) -> dict:
        w = self.run.window
        w["items_attempted"] = w["items"] * self.chunk
        w["items_failed"] = 0
        return {"edges_per_s":
                self.nnz * w["items_attempted"] / w["seconds"]}

    def release(self) -> None:
        self.op = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self):
        """(x, y) of each sampled apply, caller order."""
        for k, j in enumerate(self.kept):
            yield self.pool[j % len(self.pool)], self.buf[k]

    def judge(self) -> dict:
        rows, cols, vals, n = self.run.problem
        ref = Reference(rows, cols, vals, n, self.run.device)
        err = 0.0 if self.kept else NO_SAMPLE
        for x, y in self.outputs():
            want = ref.matvec(x)
            err = max(err, float((y.double() - want).abs().max()
                                 / want.abs().max().clamp_min(1e-300)))
        limit = self.run.cell.limits().get("max_rel_err", {}).get("limit")
        # no limit set: -1, which no reading meets
        return {"max_rel_err": (err, -1.0 if limit is None
                                else float(limit))}
