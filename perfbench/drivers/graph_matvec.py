"""The `graph_matvec` loop: closed-loop message passing y = A x on a
general graph, through the entry a user of the port calls for one:
`stream_operator` with the configuration's "layout" (kernel K2 on the
CSR in the port's own reverse Cuthill-McKee order, with `reorder` the
gathers of x into that order and of y back). x and y are in the
caller's order, the graph's own.

Everything else is the `matvec` loop's (`drivers/matvec.py`): the pool,
the chunks, the sampling, `edges_per_s`, and `correct` against the
float64 plain reference over the configuration's COO in the caller's
order.
"""

from __future__ import annotations

import os

import torch

from perfbench.generator import rhs_pool
from perfbench.harness import load_module

_matvec = load_module(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "matvec.py"), "perfbench_graph_matvec_base")


class Driver(_matvec.Driver):
    def setup(self) -> None:
        from gnnla_tpu_torch.ops.sparse import SparseOperator
        from gnnla_tpu_torch.ops.stream_op import stream_operator

        run = self.run
        rows, cols, vals, n = run.problem
        self.nnz = int(rows.shape[0])
        A = SparseOperator.from_coo(rows, cols, vals, (n, n),
                                    dtype=torch.float32, coalesce=False,
                                    device=run.device)
        layout = run.config["layout"]
        self.op = stream_operator(A, reorder=bool(layout["reorder"]),
                                  transpose=bool(layout["transpose"]))
        del A
        run.info["levels"] = [{"n": n, "nnz": self.nnz, "kind": "k2"}]
        self.pool = rhs_pool(run, n)
        self.warm_up()

    def counters(self) -> dict:
        """K2's launches and, where the port counts them, the
        caller-order gathers."""
        out = {"k2_graph": self.op.fwd.launches}
        gathers = getattr(self.op, "gathers", None)
        if gathers is not None:
            out["perm_gathers"] = gathers
        return out
