"""Diffusion-coefficient GNN, small config (reference
DiffCoeffs/train.py:153-186, scaled down for a quick demo)."""
from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.training.train_diffusion import (TrainDiffusionConfig,
                                                      train)


def main(device="cuda"):
    dev = resolve_device(device)
    cfg = TrainDiffusionConfig(num_matrices=24, n_mesh=8, epochs=8,
                               batch_size=8, n_hidden=16,
                               n_layers_internal=2, cache_dir=None,
                               checkpoint_dir=None)
    model, history = train(cfg, device=dev)
    print(f"final train loss {history['train_loss'][-1]:.5f}, "
          f"test loss {history['test_loss']:.5f}")


if __name__ == "__main__":
    main()
