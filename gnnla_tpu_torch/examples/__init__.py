"""Twins of the JAX package's single-device examples (`examples/`), on the
port: each module's `main(**sizes, device="cuda")` takes the JAX
example's arguments and prints the same lines.

    python -m gnnla_tpu_torch.examples.run_all [--device cpu]
    python -m gnnla_tpu_torch.examples.vcycle
"""
