"""Device ms a two-grid solve of kernel K2 (`csr_spmv_blocks`, the CSR
SpMV of `gnnla_tpu_torch/csrc/csr_spmv_body.cuh`): each cycle's P^T r
and P xc, in the traced segment, over the segment's solves. None where
no K2 kernel ran."""

K2 = ("csr_spmv",)


def read(run):
    if run.trace is None or not run.segment.get("items"):
        return None
    s = run.trace.seconds_matching(K2)
    return 1e3 * s / run.segment["items"] if s > 0 else None
