"""The share of the coarsest level's Chebyshev solves that ran as one
launch of kernel K1's Chebyshev form (the whole recurrence in one CUDA
block: `gnnla_tpu_torch/csrc/dia_spmv.cu`), in percent, from the port's
tally of `chebyshev` calls (`models/chebyshev.py::CHEB_TALLY`: each call
adds to `calls`, each that took the form to `one_launch`; a graph's
replays add theirs). 0 where no call took it; None where no call ran or
the port keeps no tally."""

import importlib


def read(run):
    module = importlib.import_module("gnnla_tpu_torch.models.chebyshev")
    tally = getattr(module, "CHEB_TALLY", None)
    if tally is None or not tally.calls:
        return None
    return 100.0 * tally.one_launch / tally.calls
