"""The artifact pipelines on the port — one module per script of the JAX
repository's `scripts/` that makes the reference's quality bar:

    python -m gnnla_tpu_torch.scripts.reproduce_jacobi
    python -m gnnla_tpu_torch.scripts.reproduce_jacobi_stable
    python -m gnnla_tpu_torch.scripts.smoother_twogrid
    python -m gnnla_tpu_torch.scripts.grid_diffusion
    python -m gnnla_tpu_torch.scripts.reproduce_diffusion
    python -m gnnla_tpu_torch.scripts.gen_results

Each takes its JAX twin's `main` arguments, defaults, flags and printed
lines, plus `--device` (the card by default; `cpu` runs the plain
versions) and `--out-dir` (default `runs/torch_artifacts/jacobi` or
`.../diffusion`; `artifacts/` is refused: it holds the JAX package's
committed results). Each writes its twin's files and JSON keys plus
"device" (the card's name and power limit, or "cpu"), and prints its
results JSON compactly as its last line. `gen_results` renders the
committed `artifacts_torch/` results into PERF.md's H100 block.
"""
