"""ELL slot layout: zero-gather aggregation on UNSTRUCTURED graphs.

`BandLayout` (see band_layout.py) covers every banded/grid FEM pattern in
the reference, but on a meshfree/k-NN graph its K = #unique diagonal
offsets explodes. `EllLayout` (ops/band.py) stores edge data
slot-per-neighbor instead: [K = max degree, N], edges of row i in slots
0..deg[i]-1, so the 4-way (min, mean, sum, max) aggregation is a masked
axis reduction with the pad mask generated on the fly from the degree
vector.

This demo shows, on a small random k-NN graph:
  1. choose_edge_layout routing the unstructured pattern to "ell",
  2. the ELL 4-way reduce vs the segment (torch_scatter-semantics) path,
  3. the DiffusionGNN ELL forward == the edge-order GNBlock forward with
     one set of parameters.
"""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device


def main(n=144, k=6, device="cuda"):
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    from gnnla_tpu_torch.core import GraphState
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
    from gnnla_tpu_torch.ops.band import EllPattern, choose_edge_layout
    from gnnla_tpu_torch.ops.segment import multi_segment_reduce
    from gnnla_tpu_torch.ops.sparse import SparseOperator

    dev = resolve_device(device)
    AGGS = ("min", "mean", "sum", "max")

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    rng = np.random.default_rng(0)
    pts = rng.random((n, 2))
    d, idx = cKDTree(pts).query(pts, k=k + 1)
    rows = np.repeat(np.arange(n), k)
    cols = idx[:, 1:].reshape(-1)
    w = np.exp(-d[:, 1:] ** 2).reshape(-1)
    A = sp.coo_matrix((w, (rows, cols)), shape=(n, n)).tocsr()
    A = (A + A.T).tocsr()
    op = SparseOperator.from_scipy(A, device=dev)

    # 1. routing: an unstructured pattern picks the ELL layout
    lay, pat, kind = choose_edge_layout(op)
    assert kind == "ell" and isinstance(pat, EllPattern)
    rows_h, _, vals_h = op.host_coo()
    print(f"k-NN-{k} graph: n={n}, E={op.nnz}, layout={kind} "
          f"(K={lay.k} slots, fill {op.nnz / (lay.k * n):.2f})")

    # 2. 4-way reduce parity vs the segment path
    slots = f32(lay.pack(vals_h))
    got = pat.multi(AGGS, slots[:, :, None])
    want = multi_segment_reduce(AGGS, f32(vals_h)[:, None],
                                torch.from_numpy(rows_h).to(dev), n)
    err = float((got - want).abs().max())
    print(f"ELL 4-way reduce vs segment path: max abs err {err:.2e}")
    assert err < 1e-5

    # 3. DiffusionGNN on the ELL pattern == edge-order forward. The port's
    # model is built for the diffusion model's three edge inputs (flax
    # infers the width at its first call): the JAX example's two features
    # and a zero column
    e_feat = np.stack([vals_h, rng.standard_normal(vals_h.size),
                       np.zeros(vals_h.size)], axis=1)
    dg = f32(rng.standard_normal((n, 1)))
    g = f32(rng.standard_normal((1,)))
    model = DiffusionGNN(n_layers_external=1, n_layers_internal=1,
                         n_hidden=8, generator=0, device=dev)
    with torch.no_grad():
        out_e = model(op, GraphState(vertices=dg, edges=f32(e_feat),
                                     globals_=g))
        e_ell = f32(np.moveaxis(lay.pack(np.ascontiguousarray(e_feat.T)),
                                0, -1))
        out_l = model(pat, GraphState(vertices=dg, edges=e_ell, globals_=g))
    err2 = float((out_l - out_e).abs().max())
    print(f"DiffusionGNN ELL forward vs edge-order: max abs err {err2:.2e}")
    assert err2 < 1e-3
    print("unstructured ELL path ok")


if __name__ == "__main__":
    main()
