"""The multichip dry run on `torch.distributed` — the twin of the JAX
repository's `__graft_entry__.py::dryrun_multichip` (`_dryrun_impl`).

Inside an initialized process group of n ranks (torchrun, or spawned
ranks), `dryrun_multichip`:

  1. builds a 2-D mesh data = dp x rows = n / dp (dp = 2 for an even
     n > 1) and takes one Adam(1e-2) step of the trainable-Jacobi MLP on
     the DIA Gelfand loss (k = 3, omega = 2/3) of 2 dp tiny small-band
     matrices: the batch over "data" (`DataParallel`), the rows of the
     probes, diagonals and band features over "rows". A row block's DIA
     apply reads max|offset| halo rows of its ring neighbours through the
     differentiable ring shifts; the Gelfand norm takes a max over probes
     of global norms, so the squared norms are summed over "rows" first
     (`psum_replicated`, whose backward passes the cotangent through:
     every rank backpropagates the same loss). The parameter gradients
     are then summed over "rows" and averaged over "data". The same step
     with no mesh (`train_jacobi.make_loss_fn`) runs beside it, and the
     loss and new parameters must agree within 1e-6;
  2. on a flat "rows" mesh over every rank, runs the sharded Jacobi,
     two-grid and multilevel cycles (finite), the sharded stencil matvec
     (within rtol/atol 1e-5 of the single-device one), K2 per shard on a
     general graph (1e-4 of scipy) and the stream V-cycle (2e-4 of
     max|x| of the single-device cycle), with the JAX function's
     fixtures and seeds;
  3. prints, on rank 0, the JAX function's line with this run's loss and
     scaling models.

    torchrun --standalone --nproc-per-node N -m gnnla_tpu_torch.parallel.dryrun

(alone, a world of one rank; `--device cpu` for gloo ranks on the host).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from gnnla_tpu_torch.models.trainable_jacobi import (
    TrainableJacobiMLP, jacobi_diag_features_banded)
from gnnla_tpu_torch.parallel.collectives import (axis_group, axis_index,
                                                  axis_size, psum,
                                                  psum_replicated)
from gnnla_tpu_torch.parallel.distributed import (gather_vector,
                                                  global_row_mesh, grid_mesh,
                                                  local_block, mesh_device)
from gnnla_tpu_torch.parallel.partition import partition_rows, shard_vector
from gnnla_tpu_torch.parallel.spmv import _halo_exchange
from gnnla_tpu_torch.training import spectral_loss
from gnnla_tpu_torch.training.data_parallel import DataParallel
from gnnla_tpu_torch.training.datasets import small_band_dataset
from gnnla_tpu_torch.training.train_jacobi import make_loss_fn

OMEGA = 2.0 / 3.0
GELFAND_K = 3
N_PROBES = 4
STEP_RTOL = 1e-6  # the step's loss and parameters against no mesh


def mesh_shape(n: int):
    """(dp, rows) of the 2-D mesh: dp = 2 for an even n > 1."""
    dp = 2 if n % 2 == 0 and n > 1 else 1
    return dp, n // dp


def step_inputs(n_batch: int):
    """The step's host data, as the JAX function draws it: the tiny
    small-band dataset (n = 8, seed 0), its high-frequency probes
    (default_rng(0), 4 a matrix), its DIA stack and band features."""
    ds = small_band_dataset(n_batch, n=8, seed=0, cache_dir=None,
                            device="cpu")
    n_v = ds.template.n_rows
    rng = np.random.default_rng(0)
    probes = np.stack([spectral_loss.high_freq_probes(
        n_v, N_PROBES, ds.coords[i], rng) for i in range(n_batch)])
    offsets, dia = ds.dia_stack()
    blay, band = ds.band_stack_nodiag()
    return dict(ds=ds, offsets=offsets, n=n_v, dia=dia.astype(np.float32),
                band=np.asarray(band, np.float32),
                diags=ds.diags.astype(np.float32),
                probes=probes.astype(np.float32), mask=blay.mask,
                deg=np.maximum(blay.deg, 1).astype(np.float32))


def _halo_rows(y: torch.Tensor, h: int, group) -> torch.Tensor:
    """[b, R, m] -> [b, R + 2h, m]: the row block with h rows of each ring
    neighbour (zeros past the global ends), differentiable."""
    b, r, m = y.shape
    ext = _halo_exchange(y.permute(1, 0, 2).reshape(r, b * m), h, group)
    return ext.reshape(r + 2 * h, b, m).permute(1, 0, 2)


def row_block_loss(model, dia, band, diags, probes, mask, deg, offsets,
                   rows_group) -> torch.Tensor:
    """The mean Gelfand damping factor of this rank's graphs from its row
    block: dia [b, K, R], band [b, K', R], diags [b, R], probes [b, R, m],
    mask [K', R], deg [R]. Replicated over the rows group."""
    h = max(abs(o) for o in offsets)
    r = diags.shape[1]
    if h > r:
        raise ValueError(f"a halo of {h} rows needs row blocks of at least "
                         f"{h} rows, have {r}")
    feats = jacobi_diag_features_banded(diags, band, mask, deg)
    dvals = model(feats).reshape(diags.shape)
    y = probes
    for _ in range(GELFAND_K):
        ye = _halo_rows(y, h, rows_group)
        ay = torch.zeros_like(y)
        for k, off in enumerate(offsets):
            ay = ay + dia[:, k, :, None] * ye[:, h + off:h + off + r, :]
        y = y - OMEGA * ay / dvals[..., None]
    norms = torch.sqrt(psum_replicated(torch.sum(y * y, dim=-2),
                                       rows_group))
    return torch.mean(norms.amax(dim=-1) ** (1.0 / GELFAND_K))


def _state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def reference_step(inputs, device):
    """(loss, new parameters) of the same step with no mesh: the
    trainer's DIA loss over the whole batch, one Adam(1e-2) step."""
    model = TrainableJacobiMLP(generator=0, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    loss_fn = make_loss_fn(model, inputs["ds"], OMEGA, GELFAND_K,
                           layout="dia")

    def put(a):
        return torch.from_numpy(a).to(device)

    loss = loss_fn(put(inputs["dia"]), put(inputs["band"]),
                   put(inputs["diags"]), put(inputs["probes"]))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return float(loss.detach()), _state(model)


def mesh_step(inputs, mesh):
    """(loss, new parameters) of the step on the data x rows mesh."""
    device = mesh_device(mesh)
    rows_g = axis_group(mesh, "rows")
    n_batch = inputs["dia"].shape[0]
    dp = DataParallel.from_args(mesh, None, n_batch)
    n_rows = axis_size(rows_g)
    if inputs["n"] % n_rows:
        raise ValueError(f"{inputs['n']} rows do not split over "
                         f"{n_rows} ranks")
    r = inputs["n"] // n_rows
    lo = axis_index(rows_g) * r

    def put(a, row_dim):
        a = torch.from_numpy(np.ascontiguousarray(a)).narrow(row_dim, lo, r)
        return a.contiguous().to(device)

    model = TrainableJacobiMLP(generator=0, device=device)
    dp.sync_parameters(model)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    batch = [dp.split(put(inputs[k], d)) for k, d in (
        ("dia", 2), ("band", 2), ("diags", 1), ("probes", 1))]
    local = row_block_loss(model, *batch, put(inputs["mask"], 1),
                           put(inputs["deg"], 0), inputs["offsets"], rows_g)
    opt.zero_grad(set_to_none=True)
    # the global loss is the mean of the data ranks' slice means
    (local / dp.world).backward()
    for p in model.parameters():
        p.grad.copy_(psum(p.grad, rows_g))
    dp.sum_gradients(model)
    opt.step()
    return float(dp.mean(local)), _state(model)


def _flat_checks(flat, n: int) -> dict:
    """The sharded Jacobi, cycles, stencil and stream paths on the flat
    rows mesh, with the JAX function's fixtures, seeds and tolerances."""
    from scipy import sparse as sp

    from gnnla_tpu_torch.models.multigrid import setup_sa_multigrid
    from gnnla_tpu_torch.models.vcycle import setup_twogrid, vcycle
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.ops.stencil import stencil_matvec, stencil_taps
    from gnnla_tpu_torch.parallel.spmv import make_sharded_jacobi
    from gnnla_tpu_torch.parallel.stencil import (make_sharded_stencil_matvec,
                                                  shard_planes, shard_vec2d,
                                                  stencil_scaling_model)
    from gnnla_tpu_torch.parallel.stream import (build_sharded_stream,
                                                 stream_scaling_model)
    from gnnla_tpu_torch.parallel.vcycle import (make_sharded_multigrid_cycle,
                                                 make_sharded_stream_vcycle,
                                                 make_sharded_vcycle)
    from gnnla_tpu_torch.problems import laplacian_2d

    dev = mesh_device(flat)
    out = {}

    def put(v, part):
        return local_block(shard_vector(np.asarray(v, np.float32), part),
                           flat)

    def finite(t, what):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"sharded {what}: not finite")

    # ---- sharded Jacobi and two-grid cycle: 64 rows over n shards
    A = laplacian_2d(8, device=dev)
    part = partition_rows(A, n)
    jac = make_sharded_jacobi(part, flat)
    ones, zeros = np.ones(64), np.zeros(64)
    finite(jac(put(ones, part), put(zeros, part),
               put(A.host_diagonal(), part), 0.7, 3), "jacobi")
    setup = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0)
    cycle, part_v = make_sharded_vcycle(setup, flat, n_pre=1, n_post=1,
                                        coarse_deg=2)
    finite(cycle(put(ones, part_v), put(zeros, part_v)), "two-grid cycle")

    # ---- multilevel cycle: sharded fine levels, replicated coarse tail
    A_ml = laplacian_2d(16, device=dev)
    setup_ml = setup_sa_multigrid(A_ml, min_coarse=8)
    mcycle, part_m = make_sharded_multigrid_cycle(
        setup_ml, flat, n_pre=1, n_post=1, coarse_deg=2,
        n_sharded_levels=2 if setup_ml.n_levels >= 3 else 1)
    finite(mcycle(put(np.ones(A_ml.n_rows), part_m),
                  put(np.zeros(A_ml.n_rows), part_m)), "multigrid cycle")

    # ---- stencil matvec (ring-halo grid rolls)
    ng = 4 * n
    shifts, planes = stencil_taps(laplacian_2d(ng, device=dev), (ng, ng))
    planes = planes.reshape(-1, ng, ng).astype(np.float32)
    xs = np.random.default_rng(3).standard_normal((ng, ng)).astype(
        np.float32)
    mv = make_sharded_stencil_matvec(shifts, (ng, ng), flat)
    y_sh = gather_vector(mv(shard_planes(planes, flat), shard_vec2d(xs, flat)),
                         flat).reshape(ng, ng)
    y_ref = stencil_matvec(torch.from_numpy(planes).to(dev), shifts,
                           torch.from_numpy(xs).to(dev))
    if not torch.allclose(y_sh, y_ref, rtol=1e-5, atol=1e-5):
        raise AssertionError("sharded stencil parity failed")
    out["stencil_max_abs_err"] = float((y_sh - y_ref).abs().max())

    # ---- K2 per shard on a general graph (2 tiles a shard)
    n_st = 1024 * 2 * n
    rng_st = np.random.default_rng(7)
    idx = np.arange(n_st)
    r_, c_ = [], []
    for off in (-2, -1, 0, 1, 2):
        r_.append(idx)
        c_.append(np.clip(idx + off, 0, n_st - 1))
    Ast = sp.csr_matrix(
        (rng_st.standard_normal(5 * n_st).astype(np.float32),
         (np.concatenate(r_), np.concatenate(c_))), shape=(n_st, n_st))
    Ast.sum_duplicates()
    p_st = rng_st.permutation(n_st)
    Ast = Ast[p_st][:, p_st].tocsr()
    Ast.sort_indices()
    skern = build_sharded_stream(Ast, flat, "rows")
    xs_st = rng_st.standard_normal(n_st).astype(np.float32)
    y_st, y_st_ref = skern.matvec(xs_st), Ast @ xs_st
    if not np.allclose(y_st, y_st_ref, rtol=1e-4, atol=1e-4):
        raise AssertionError("sharded stream parity failed")
    out["stream_max_abs_err"] = float(np.abs(y_st - y_st_ref).max())
    out["stream_model"] = stream_scaling_model(skern)
    # projected at the bench fixture's scale (1M rows over the mesh)
    out["stream_model_1m"] = stream_scaling_model(
        skern, scale_rows=(1 << 20) / n / (n_st / n))

    # ---- the two-grid cycle with its fine level on K2 shards
    ngv = 32 * max(1, int(np.ceil(np.sqrt(n * 1024) / 32)))
    Av = laplacian_2d(ngv, device=dev).eliminate_zeros()
    pv = np.random.default_rng(11).permutation(Av.n_rows)
    Avh = Av.to_scipy().tocsr()[pv][:, pv].tocsr()
    Avh.sort_indices()
    Av = SparseOperator.from_scipy(Avh, device=dev)
    setup_v = setup_twogrid(Av, theta=0.25, splitting="pmis", seed=0)
    cyc_s, kern_v = make_sharded_stream_vcycle(setup_v, flat, "rows")
    bv = np.random.default_rng(12).standard_normal(Av.n_rows).astype(
        np.float32)
    x3v = cyc_s(kern_v.shard(kern_v.to_padded(bv)),
                kern_v.shard(kern_v.to_padded(np.zeros_like(bv))))
    x_v = kern_v.from_padded(kern_v.gather(x3v))
    x_ref_v = vcycle(setup_v, torch.from_numpy(bv).to(dev),
                     torch.zeros(Av.n_rows, device=dev)).cpu().numpy()
    if not np.allclose(x_v, x_ref_v, rtol=2e-4,
                       atol=2e-4 * np.abs(x_ref_v).max()):
        raise AssertionError("sharded stream vcycle parity failed")
    out["stream_vcycle_max_abs_err"] = float(np.abs(x_v - x_ref_v).max())

    out["stencil_model"] = stencil_scaling_model(2048, 2048, len(shifts), n)
    out.update(n_st=n_st, h_tiles=skern.h_tiles, stream_kernel=skern,
               stream_vcycle_kernel=kern_v,
               k2_launches=skern.fwd.launches + kern_v.fwd.launches)
    return out


def dryrun_multichip(n_ranks=None, *, device_type=None) -> dict:
    """Run the dry run on every rank of the initialized process group
    (`n_ranks`, when given, must be its size) and return this rank's
    results: the step's loss and new parameters beside the no-mesh
    step's, the flat-mesh checks' errors and scaling models, the printed
    line. `device_type` ("cuda" or "cpu") defaults to the backend's; gloo
    ranks that share a card pass "cuda". The MLP starts from seed 0."""
    if not dist.is_initialized():
        raise RuntimeError("dryrun_multichip needs an initialized process "
                           "group (torchrun, or initialize_distributed)")
    n = dist.get_world_size()
    if n_ranks is not None and n_ranks != n:
        raise ValueError(f"need {n_ranks} ranks, have {n}")
    dp, rows_ax = mesh_shape(n)
    mesh = grid_mesh((dp, rows_ax), ("data", "rows"), device_type)
    device = mesh_device(mesh)

    # ---- one training step on the data x rows mesh
    inputs = step_inputs(2 * dp)
    loss, params = mesh_step(inputs, mesh)
    if not math.isfinite(loss):
        raise AssertionError(f"training-step loss not finite: {loss}")
    ref_loss, ref_params = reference_step(inputs, device)
    loss_gap = abs(loss - ref_loss) / abs(ref_loss)
    param_gap = max(float(np.max(np.abs(params[k] - ref_params[k])))
                    for k in params)
    if loss_gap > STEP_RTOL or param_gap > STEP_RTOL:
        raise AssertionError(
            f"the mesh step disagrees with no mesh: loss {loss} vs "
            f"{ref_loss}, parameters {param_gap}")

    # ---- the flat rows mesh
    flat = global_row_mesh("rows", device_type)
    res = _flat_checks(flat, n)
    m, ms, ms_big = (res["stencil_model"], res["stream_model"],
                     res["stream_model_1m"])
    line = (f"dryrun_multichip({n}): train-step loss {loss:.5f}, "
            f"sharded jacobi + vcycle + multigrid-cycle + stencil + stream "
            f"+ stream-vcycle ok "
            f"(mesh data={dp} x rows={rows_ax}); modeled stencil-SpMV "
            f"scaling at 2048^2 on {n} chips: "
            f"{m['efficiency_serial']:.1%} serial / "
            f"{m['efficiency_overlapped']:.1%} overlapped "
            f"(halo {m['comm_bytes_per_chip'] / 1024:.0f} KiB/chip vs "
            f"local {m['local_bytes_per_chip'] / 1024 ** 2:.1f} MiB/chip); "
            f"sharded stream (general graph, halo {res['h_tiles']} tiles): "
            f"{ms['efficiency_serial']:.1%} serial / "
            f"{ms['efficiency_overlapped']:.1%} overlapped at "
            f"n={res['n_st']}, "
            f"{ms_big['efficiency_serial']:.1%} serial at n=1M")
    if dist.get_rank() == 0:
        print(line, flush=True)
    res.update(loss=loss, reference_loss=ref_loss, loss_rel_gap=loss_gap,
               params=params, reference_params=ref_params,
               param_max_abs_gap=param_gap, mesh=(dp, rows_ax), line=line)
    return res


if __name__ == "__main__":
    import argparse

    from gnnla_tpu_torch.parallel.distributed import launched_ranks

    parser = argparse.ArgumentParser(prog="gnnla_tpu_torch.parallel.dryrun")
    parser.add_argument("--device", default="cuda",
                        help="torch device type (default: the card)")
    args = parser.parse_args()
    with launched_ranks(args.device):
        dryrun_multichip()
