"""Strength-of-connection (classic + SA) and direct interpolation vs the
closed-form formulas (reference SOCClassicGNN.py:149-187, SOCSAGNN.py,
DirectInterpGNN.py:176-261, matlab/test_classic_soc.m, test_sa_soc.m)."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.amg.interp import assemble_prolongation
from gnnla_tpu_torch.amg.splitting import split
from gnnla_tpu_torch.models import direct_interp, soc_classic, soc_sa
from gnnla_tpu_torch.problems import laplacian_2d


def main(n=10, theta=0.25, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    And = A.remove_diagonal()
    rows, cols, vals = And.host_coo()

    # classic SOC: S_ij = relu(-A_ij / max_k(-A_ik) - theta)
    s = soc_classic(And, theta).cpu().numpy()
    v = np.full(A.n_rows, -np.inf)
    np.maximum.at(v, rows, -vals)
    v[np.isneginf(v)] = 0.0
    s_ref = np.maximum(-vals / v[rows] - theta, 0.0)
    mism = int(np.sum((s > 0) != (s_ref > 0)))
    print(f"classic SOC mismatches vs formula: {mism}")
    assert mism == 0

    # SA SOC: S_ij = A_ij^2 / (A_ii A_jj)
    d = A.host_diagonal()
    s_sa = soc_sa(And, torch.from_numpy(d.astype(np.float32)).to(dev))
    s_sa = s_sa.cpu().numpy()
    s_sa_ref = vals ** 2 / (d[rows] * d[cols])
    print(f"SA SOC rel error: "
          f"{np.linalg.norm(s_sa - s_sa_ref) / np.linalg.norm(s_sa_ref):.3e}")

    # direct interpolation: w_ij = (1-C_i)(-A_ij alpha_i)
    import scipy.sparse as sp
    strong = s > 0
    S = sp.coo_matrix((strong.astype(float), (rows, cols)),
                      shape=A.shape).tocsr()
    coarse = split(S, method="cljp", seed=0)
    w = direct_interp(
        And, A.diagonal(), torch.from_numpy(coarse.astype(np.float32)).to(dev),
        torch.from_numpy(strong.astype(np.float32)).to(dev))
    P = assemble_prolongation(And, coarse, w.cpu().numpy())
    print(f"P shape {P.shape}, nnz {P.nnz}, "
          f"{int(coarse.sum())}/{A.n_rows} coarse points")
    # coarse rows of P are identity rows
    Pd = P.to_dense().cpu().numpy()
    cmap = np.cumsum(coarse) - 1
    for i in np.flatnonzero(coarse)[:5]:
        assert Pd[i, cmap[i]] == 1.0


if __name__ == "__main__":
    main()
