"""gnnla_tpu_torch — the PyTorch/CUDA port of gnnla_tpu.

The JAX package `gnnla_tpu` is the reference; this package mirrors its
layout (`ops/`, `amg/`, `models/`, `problems/`) so each module's
counterpart sits at the same path. Plain tensor code is PyTorch; every
TPU kernel on a ported path is a hand-written CUDA kernel for Hopper
(`csrc/`, built by `_build.py`), with its plain PyTorch version beside
it in the same module.

Every entry point takes `device=` and defaults to CUDA; without a card it
raises unless the caller asks for `device="cpu"` (which runs the plain
versions — the tests do this).

This package never imports jax, flax or gnnla_tpu.
"""

__version__ = "0.1.0"
