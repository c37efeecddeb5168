"""The share of K1's launches in the solves that apply a vertex update
in the same launch (the Jacobi and residual forms of
`gnnla_tpu_torch/csrc/dia_spmv.cu`, whose names hold "jacobi" or
"residual" beside "dia_tiles"), in percent of all K1 launches in the
traced segment. 0 on a port without those forms; None where no K1
kernel ran."""

from perfbench.readers import K1

FUSED = ("jacobi", "residual")


def read(run):
    if run.trace is None:
        return None
    k1 = fused = 0
    for name, (_, launches) in run.trace.kernels.items():
        low = name.lower()
        if any(k in low for k in K1):
            k1 += launches
            if any(f in low for f in FUSED):
                fused += launches
    return 100.0 * fused / k1 if k1 else None
