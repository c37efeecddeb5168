"""Command-line drivers for the two training pipelines — the PyTorch
counterpart of gnnla_tpu/cli.py, with the same sub-commands, flags,
defaults, hyperparameter grid and printed lines, plus `--device` (the
card by default; without one the run stops unless `--device cpu` is
given).

Reference counterparts: the argparse grid slicer (the reference's
DiffCoeffs/parsing.py:42-65) and the in-code hyperparameter grid + top-5
combos (DiffCoeffs/train.py:114-145);
the trainable-Jacobi driver has no CLI in the reference (constants in
train.py:52-60) — flags are an upgrade, not a port.

Usage:
    python -m gnnla_tpu_torch.cli diffusion --num-combos
    python -m gnnla_tpu_torch.cli diffusion --show-combos
    python -m gnnla_tpu_torch.cli diffusion --start-index 0 --end-index 2 \
        --num-matrices 100 --epochs 20
    python -m gnnla_tpu_torch.cli jacobi --num-matrices 1000 --epochs 10
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import sys
from typing import List, Optional, Tuple

# (seed, encoder, decoder, n_layers_external, n_layers_internal, n_hidden)
# — the reference's top-5 performers (DiffCoeffs/train.py:136-141).
TOP_COMBOS: List[Tuple] = [
    (41, None, None, 1, 3, 64),
    (41, (3, 16), None, 1, 2, 32),
    (41, None, (3, 16), 1, 4, 64),
    (41, None, None, 1, 4, 64),
    (41, (3, 16), (3, 16), 1, 1, 32),
]


def full_grid() -> List[Tuple]:
    """The full hyperparameter grid (DiffCoeffs/train.py:120-125, 134)."""
    seeds = [41]
    encoders = [None, (1, 16), (3, 16)]
    decoders = [None, (1, 16), (3, 16)]
    ext = [1, 2, 3]
    internal = [1, 2, 3, 4]
    hidden = [8, 16, 32, 64]
    return list(itertools.product(seeds, encoders, decoders, ext, internal,
                                  hidden))


def _diffusion_parser(sub):
    p = sub.add_parser("diffusion", help="diffusion-coefficient GNN grid")
    p.add_argument("--num-combos", action="store_true",
                   help="print the number of hyperparameter combinations")
    p.add_argument("--show-combos", action="store_true",
                   help="list the hyperparameter combinations")
    p.add_argument("--full-grid", action="store_true",
                   help="use the full 432-combo grid instead of the top-5")
    p.add_argument("--start-index", type=int, default=0)
    p.add_argument("--end-index", type=int, default=None)
    p.add_argument("--num-matrices", type=int, default=1000)
    p.add_argument("--n-mesh", type=int, default=32)
    p.add_argument("--max-freq", type=float, default=3.0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--cache-dir", default="data_cache")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p


def _jacobi_parser(sub):
    p = sub.add_parser("jacobi", help="trainable Jacobi diagonal")
    p.add_argument("--num-matrices", type=int, default=1000)
    p.add_argument("--n-mesh", type=int, default=38)
    p.add_argument("--epochs", type=int, default=62)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=54681)
    p.add_argument("--cache-dir", default="data_cache")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--eigen-analysis", default=None, metavar="NPZ",
                   help="run the post-training eigen analysis and save the "
                        "npz artifact here (train.py:215-225 analogue)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p


def run_diffusion(args) -> int:
    combos = full_grid() if args.full_grid else TOP_COMBOS
    if args.num_combos:
        print(f"There are {len(combos)} total combinations")
        return 0
    if args.show_combos:
        for i, c in enumerate(combos):
            print(f"{i}: {c}")
        return 0

    from gnnla_tpu_torch._device import resolve_device
    td = importlib.import_module("gnnla_tpu_torch.training.train_diffusion")
    device = resolve_device(args.device)
    end = len(combos) if args.end_index is None else args.end_index
    for g_idx in range(args.start_index, end):
        seed, enc, dec, n_ext, n_int, n_hidden = combos[g_idx]
        print(f"Combination {g_idx}: seed={seed} encoder={enc} decoder={dec} "
              f"ext={n_ext} int={n_int} hidden={n_hidden}")
        cfg = td.TrainDiffusionConfig(
            num_matrices=args.num_matrices, n_mesh=args.n_mesh,
            max_freq=args.max_freq, n_layers_external=n_ext,
            n_layers_internal=n_int, n_hidden=n_hidden, encoder=enc,
            decoder=dec, epochs=args.epochs, batch_size=args.batch_size,
            seed=seed, cache_dir=args.cache_dir,
            checkpoint_dir=args.checkpoint_dir)
        td.train(cfg, device=device)
    return 0


def check_jacobi_splits(cfg) -> None:
    """Raise ValueError when cfg.num_matrices leaves the train, validation
    or test split empty (the trainer splits n_train, n_val, n_test off one
    permutation). The JAX CLI starts such a run and crashes on the first
    empty split (np.stack of no probes)."""
    need = cfg.n_train + cfg.n_val + 1
    if cfg.num_matrices < need:
        raise ValueError(
            f"--num-matrices {cfg.num_matrices} leaves a split empty: the "
            f"trainer takes {cfg.n_train} training and {cfg.n_val} "
            f"validation matrices before the test split, so at least "
            f"{need} matrices are needed")


def run_jacobi(args) -> int:
    from gnnla_tpu_torch._device import resolve_device
    tj = importlib.import_module("gnnla_tpu_torch.training.train_jacobi")
    cfg = tj.TrainJacobiConfig(
        num_matrices=args.num_matrices, n_mesh=args.n_mesh,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        seed=args.seed, cache_dir=args.cache_dir,
        checkpoint_dir=args.checkpoint_dir)
    check_jacobi_splits(cfg)
    device = resolve_device(args.device)
    model, history = tj.train(cfg, device=device)

    if args.eigen_analysis:
        from gnnla_tpu_torch.evaluation import (eigen_analysis,
                                                save_eigen_analysis)
        from gnnla_tpu_torch.training.datasets import small_band_dataset
        ds = small_band_dataset(min(cfg.num_matrices, 64), n=cfg.n_mesh,
                                seed=cfg.seed, cache_dir=cfg.cache_dir,
                                device=device)
        analysis = eigen_analysis(model, ds, widths=cfg.widths)
        save_eigen_analysis(args.eigen_analysis, analysis)
        print(f"eigen analysis saved to {args.eigen_analysis}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="gnnla_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _diffusion_parser(sub)
    _jacobi_parser(sub)
    args = parser.parse_args(argv)
    if args.command == "diffusion":
        return run_diffusion(args)
    return run_jacobi(args)


if __name__ == "__main__":
    sys.exit(main())
