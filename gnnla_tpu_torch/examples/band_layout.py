"""Band-layout GN execution: the zero-gather path for learned models.

The reference's learned models aggregate edge features onto vertices with
torch_scatter's 4-way (min, mean, sum, max) reduce
(TrainableJacobiGNN.py:65-68, LearnDiffusionCoeffs.py:303-341). The
framework stores edge data in DIA band order instead (ops/band.py):
aggregation becomes a masked axis reduction, neighbor reads become
shifts/rolls.

This demo shows the three pieces on a small operator:
  1. BandLayout: host pack + the 4-way reduce, checked against the
     segment (torch_scatter-semantics) reducers,
  2. jacobi_diag_features_banded == jacobi_diag_features,
  3. the DiffusionGNN grid-layout forward == the edge-order GNBlock
     forward with one set of parameters.
"""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device


def main(n=12, device="cuda"):
    from gnnla_tpu_torch.models.trainable_jacobi import (
        jacobi_diag_features, jacobi_diag_features_banded)
    from gnnla_tpu_torch.ops.band import BandLayout, band_multi_reduce
    from gnnla_tpu_torch.ops.segment import multi_segment_reduce
    from gnnla_tpu_torch.problems import laplacian_2d

    dev = resolve_device(device)
    AGGS = ("min", "mean", "sum", "max")

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # 1. layout + 4-way reduce vs the segment path
    A = laplacian_2d(n, device=dev).eliminate_zeros()
    nd = A.remove_diagonal()
    lay = BandLayout(nd)
    rows, _, vals = nd.host_coo()
    bands = f32(lay.pack(vals))
    mask = torch.from_numpy(lay.mask).to(dev)
    deg = f32(np.maximum(lay.deg, 1))
    got = band_multi_reduce(AGGS, bands, mask, deg)
    want = multi_segment_reduce(AGGS, f32(vals)[:, None],
                                torch.from_numpy(rows).to(dev), nd.n_rows)
    err = float((got - want).abs().max())
    print(f"band 4-way reduce vs segment path: K={lay.k} bands, "
          f"E={lay.n_edges} edges, max abs err {err:.2e}")
    assert err < 1e-5

    # 2. the trainable-Jacobi feature vector, banded
    diag = A.diagonal()
    f_band = jacobi_diag_features_banded(diag, bands, mask, deg)
    f_edge = jacobi_diag_features(nd, diag)
    ferr = float((f_band - f_edge).abs().max())
    print(f"jacobi_diag_features banded vs edge: max abs err {ferr:.2e}")
    assert ferr < 1e-5

    # 3. diffusion GN forward, one set of parameters, two layouts
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
    from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset
    from gnnla_tpu_torch.training.train_diffusion import (edge_features,
                                                          make_apply,
                                                          make_apply_banded)

    ds = cosine_diffusion_dataset(2, n=8, seed=3, cache_dir=None,
                                  device=dev)
    rel = edge_features(ds, 8)
    model = DiffusionGNN(n_layers_external=2, n_layers_internal=2,
                         n_hidden=8, encoder=(1, 8), generator=0, device=dev)
    with torch.no_grad():
        out_e = make_apply(model, ds, rel)(
            f32(ds.offdiag_vals), f32(ds.diags), f32(ds.globals_))
        apply_g, pack = make_apply_banded(model, ds, rel, grid_shape=(8, 8))
        out_g = apply_g(f32(pack(ds.offdiag_vals)), f32(ds.diags),
                        f32(ds.globals_))
    gerr = float((out_g - out_e).abs().max())
    kk = pack(ds.offdiag_vals).shape[1]
    print(f"DiffusionGNN grid-layout forward ({kk} stencil classes, "
          f"mask-free) vs edge path: max abs err {gerr:.2e}")
    assert gerr < 1e-4


if __name__ == "__main__":
    main()
