"""Row-partitioned sharded kernels on a mesh of ranks: the halo-exchange
SpMV, sharded Jacobi, the psum-reduced power method, K2 per shard on a
general graph, the sharded two-grid cycle on K2 and sharded mg_pcg. Each
rank runs this program on its own device:

    torchrun --nproc-per-node N -m gnnla_tpu_torch.examples.distributed

Run alone (`python -m gnnla_tpu_torch.examples.distributed [--device
cpu]`) it starts a world of one rank itself and ends it. Rank 0 prints.
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import jacobi, power_method
from gnnla_tpu_torch.parallel import (gather_vector, global_row_mesh,
                                      launched_ranks, local_block,
                                      make_sharded_jacobi,
                                      make_sharded_power_method,
                                      partition_rows, shard_vector,
                                      unshard_vector)
from gnnla_tpu_torch.problems import laplacian_2d


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def run(n: int, dev: torch.device) -> None:
    """The example on the ranks of an initialized process group."""
    mesh = global_row_mesh(device_type=dev.type)
    n_dev = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"{n_dev} devices: {[f'{dev.type}:{r}' for r in range(n_dev)]}")

    def put(v, part):
        return local_block(shard_vector(np.asarray(v, np.float32), part),
                           mesh)

    def whole(v_local, part):
        return unshard_vector(gather_vector(v_local, mesh), part).cpu()

    A = laplacian_2d(n, device=dev)
    part = partition_rows(A, n_dev)
    rng = np.random.default_rng(0)
    b = rng.random(n * n).astype(np.float32)
    x0 = rng.random(n * n).astype(np.float32)
    bs, xs = put(b, part), put(x0, part)
    ds = put(A.host_diagonal(), part)

    jac = make_sharded_jacobi(part, mesh)
    out = whole(jac(bs, xs, ds, 0.7, 10), part)
    ref = jacobi(A, torch.from_numpy(b).to(dev), torch.from_numpy(x0).to(
        dev), omega=0.7, n_iters=10).cpu()
    say(f"sharded jacobi rel err vs single-device: {_rel(out, ref):.3e}")

    pm = make_sharded_power_method(part, mesh)
    lam, _ = pm(put(x0, part), 30)
    lam_ref, _ = power_method(A, torch.from_numpy(x0).to(dev), n_iters=30)
    say(f"sharded power method: {float(lam):.6f} "
        f"vs single-device {float(lam_ref):.6f}")

    # --- K2 per shard: the general-graph fast path -----------------------
    # (one CSR per rank, ring halos bounded by the RCM bandwidth)
    from scipy import sparse as sp

    from gnnla_tpu_torch.parallel import (build_sharded_stream,
                                          stream_scaling_model)

    ns = 1024 * 2 * n_dev
    rng2 = np.random.default_rng(1)
    idx = np.arange(ns)
    r_, c_ = [], []
    for off in (-2, -1, 0, 1, 2):
        r_.append(idx)
        c_.append(np.clip(idx + off, 0, ns - 1))
    As = sp.csr_matrix((rng2.standard_normal(5 * ns).astype(np.float32),
                        (np.concatenate(r_), np.concatenate(c_))),
                       shape=(ns, ns))
    As.sum_duplicates()
    p = rng2.permutation(ns)
    As = As[p][:, p].tocsr()
    As.sort_indices()
    kern = build_sharded_stream(As, mesh, "rows")
    xg = rng2.standard_normal(ns).astype(np.float32)
    y = kern.matvec(xg)
    m = stream_scaling_model(kern)
    say(f"sharded stream (general graph, halo {kern.h_tiles} tiles) "
        f"rel err {_rel(y, As @ xg):.3e}; modeled scaling "
        f"{m['efficiency_serial']:.1%} serial / "
        f"{m['efficiency_overlapped']:.1%} overlapped")

    # --- distributed two-grid V-cycle on K2 shards -----------------------
    # (fine-level smoothing and residual on K2; psum restriction,
    # replicated coarse Chebyshev)
    from gnnla_tpu_torch.models import setup_twogrid, vcycle
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.parallel import make_sharded_stream_vcycle

    ngv = 32 * max(1, int(np.ceil(np.sqrt(n_dev * 1024) / 32)))
    Av = laplacian_2d(ngv, device=dev).eliminate_zeros()
    pv = rng2.permutation(Av.n_rows)
    Avh = Av.to_scipy().tocsr()[pv][:, pv].tocsr()
    Avh.sort_indices()
    Av = SparseOperator.from_scipy(Avh, device=dev)
    setup_v = setup_twogrid(Av, theta=0.25, splitting="pmis", seed=0)
    cyc, kv = make_sharded_stream_vcycle(setup_v, mesh, "rows")
    bv = rng2.standard_normal(Av.n_rows).astype(np.float32)
    x_l = cyc(kv.shard(kv.to_padded(bv)),
              kv.shard(kv.to_padded(np.zeros_like(bv))))
    ref_v = vcycle(setup_v, torch.from_numpy(bv).to(dev),
                   torch.zeros(Av.n_rows, device=dev)).cpu().numpy()
    errv = _rel(kv.from_padded(kv.gather(x_l)), ref_v)
    say(f"sharded stream V-cycle ({ngv}x{ngv} scrambled Laplacian, "
        f"{n_dev} shards) rel err vs single-device: {errv:.3e}")

    # --- distributed multilevel PCG: the large-N solve, sharded ----------
    # (SA hierarchy; finest levels row-sharded, replicated coarse tail; the
    # CG inner products are psums)
    from gnnla_tpu_torch.models.multigrid import setup_sa_multigrid
    from gnnla_tpu_torch.parallel import make_sharded_mg_pcg

    Am = laplacian_2d(48, device=dev)
    setup_m = setup_sa_multigrid(Am, min_coarse=16)
    solve, pm_ = make_sharded_mg_pcg(setup_m, mesh, flip_sign=True,
                                     n_sharded_levels=2)
    bm = rng.random(Am.n_rows).astype(np.float32)
    _, hist = solve(put(bm, pm_), put(np.zeros(Am.n_rows), pm_), 8)
    say(f"sharded mg_pcg ({setup_m.n_levels} levels, 2 sharded): "
        f"|r| {float(np.linalg.norm(bm)):.2e} -> {hist[-1]:.2e} "
        f"in 8 iters")


def main(n=16, device="cuda"):
    """The example under torchrun (the ranks it started), or alone as a
    world of one rank that this call starts and ends."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return run(n, dev)
    with launched_ranks(dev) as dev:
        run(n, dev)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        prog="gnnla_tpu_torch.examples.distributed")
    parser.add_argument("--device", default="cuda",
                        help="torch device type of every rank (default: "
                             "the card)")
    main(device=parser.parse_args().device)
