"""The share of the nonzeros kernel K2 applied that its warp blocks
summed (rows of 65 to 256 nonzeros and their neighbours, a warp a row:
`gnnla_tpu_torch/csrc/csr_spmv_body.cuh`), in percent, from the port's
tally of K2 launches (`ops/stream_spmv.py::K2_TALLY`: each launch adds
its CSR's nonzeros and its warp blocks' nonzeros; a graph's replays add
theirs). 0 where no CSR has such a row; None where no K2 kernel ran or
the port keeps no tally."""


def read(run):
    from gnnla_tpu_torch.ops import stream_spmv
    tally = getattr(stream_spmv, "K2_TALLY", None)
    if tally is None or not tally.nnz:
        return None
    return 100.0 * tally.warp_nnz / tally.nnz
