"""Twins of the JAX repository's `scratch/` scripts: the probes and the
prototype through which the general-graph SpMV was designed, each a module
of the same name with a `main()`:

    python -m gnnla_tpu_torch.scratch.<name> [--cpu] [options]

  * `proto_ellw`      — the windowed ELL SpMV (kernel K6) on a Delaunay
                        Laplacian in RCM order.
  * `probe_dyngather` — the gather probes (kernels K7 and K8).
  * `probe_stream`    — y = A x on 2 x 1024 rows of 5 random edges, on K6
                        (`from_slots`) and on K2.
  * `ablate_stream`   — K2 with its stages removed (kernel K9) on the 1M
                        Delaunay Laplacian.
  * `bench_stream`    — K2 on the k-NN-32 Laplacian: error, VJP, edges/s.
  * `probe_gather`    — the four gather formulations of an ELL SpMV in
                        plain PyTorch.

Each runs on the card unless given `--cpu` (which runs the kernels' plain
versions on the host), prints its JAX twin's lines (setup, error, rate)
with ms per launch, and raises where a check fails.
"""
