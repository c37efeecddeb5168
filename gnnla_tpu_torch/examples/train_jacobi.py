"""Trainable Jacobi diagonal, small config (reference
TrainableJacobiDiag/train.py:52-133, scaled down for a quick demo)."""
from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.training.datasets import small_band_dataset
from gnnla_tpu_torch.training.train_jacobi import (TrainJacobiConfig,
                                                   evaluate_vs_baselines,
                                                   train)


def main(device="cuda"):
    dev = resolve_device(device)
    cfg = TrainJacobiConfig(num_matrices=48, n_mesh=10, epochs=8,
                            batch_size=16, n_train=32, n_val=8, n_test=8,
                            m_probes=8, cache_dir=None, checkpoint_dir=None)
    model, history = train(cfg, device=dev)
    ds = small_band_dataset(8, n=cfg.n_mesh, seed=7, cache_dir=None,
                            device=dev)
    base = evaluate_vs_baselines(model.state_dict(), ds, cfg, max_graphs=8)
    print("mean exact damping factors (lower is better):")
    for k, v in base.items():
        print(f"  {k:8s}: {v:.4f}")


if __name__ == "__main__":
    main()
