"""Run every example twin (the port's counterpart of examples/run_all.py):

    python -m gnnla_tpu_torch.examples.run_all [--device cuda|cpu]

Prints each example's output and seconds, exits 1 if any failed.
`distributed` runs as a world of one rank that it starts and ends itself
(under torchrun it runs on the ranks torchrun started)."""
import argparse
import importlib
import sys
import time

MODULES = ["matvec", "residual_norm", "jacobi", "chebyshev", "power_method",
           "soc_interp", "vcycle", "multigrid_pcg", "train_jacobi",
           "train_diffusion", "band_layout", "unstructured_ell",
           "distributed"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gnnla_tpu_torch.examples.run_all")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    failures = []
    for name in MODULES:
        print(f"\n=== {name} " + "=" * (60 - len(name)), flush=True)
        t0 = time.time()
        try:
            importlib.import_module(
                f"gnnla_tpu_torch.examples.{name}").main(device=args.device)
            print(f"--- {name} ok ({time.time() - t0:.1f}s)", flush=True)
        except Exception as e:  # noqa: BLE001 — report-and-continue sweep
            failures.append(name)
            print(f"--- {name} FAILED: {type(e).__name__}: {e}", flush=True)
    print(f"\n{len(MODULES) - len(failures)}/{len(MODULES)} examples passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
