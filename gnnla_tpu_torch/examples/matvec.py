"""SpMV as a GN block, vs scipy (reference MatVecGNN.py:117-162); the
multi-column product on kernel K3."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import matvec, matvec_gnn
from gnnla_tpu_torch.problems import laplacian_2d


def main(n=25, seed=24601, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(n * n).astype(np.float32)).to(dev)
    y = matvec(A, x)
    y_gnn = matvec_gnn(A, x)
    x64 = x.double().cpu().numpy()
    y_ref = A.to_scipy() @ x64
    rel = np.linalg.norm(y.cpu().numpy() - y_ref) / np.linalg.norm(y_ref)
    rel_gnn = (np.linalg.norm(y_gnn.cpu().numpy() - y_ref)
               / np.linalg.norm(y_ref))
    print(f"matvec     rel error: {rel:.3e}")
    print(f"matvec_gnn rel error: {rel_gnn:.3e}")
    # multi-column X (reference MatVecGNN.py:128-129)
    X = torch.from_numpy(rng.random((n * n, 3)).astype(np.float32)).to(dev)
    Y = matvec(A, X)
    rel_mc = np.linalg.norm(Y.cpu().numpy()
                            - A.to_scipy() @ X.double().cpu().numpy())
    print(f"multi-col  abs error: {rel_mc:.3e}")
    assert rel < 1e-5 and rel_gnn < 1e-5

    # multi-column at kernel speed: all columns in one pass over the
    # RCM-ordered CSR, kernel K3 on the card (the plain version on the CPU)
    from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV, rcm_csr
    B, _ = rcm_csr(A.to_scipy().tocsr().astype(np.float32))
    mm = CsrSpMV(B, device=dev)
    Xs = rng.random((n * n, 3)).astype(np.float32)
    Ys = mm(torch.from_numpy(Xs).to(dev)).cpu().numpy()
    rel_mm = np.linalg.norm(Ys - B @ Xs) / np.linalg.norm(B @ Xs)
    ran = ("kernel K3, csrc/csr_spmm.cu" if mm.launches_mm
           else "plain version on the CPU")
    print(f"stream SpMM rel error: {rel_mm:.3e} ({ran})")
    assert rel_mm < 1e-5


if __name__ == "__main__":
    main()
