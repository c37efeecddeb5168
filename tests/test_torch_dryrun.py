"""The port's multichip dry run (`gnnla_tpu_torch.parallel.dryrun`)
against the same step with no mesh and against the JAX dry run's loss on
the CPU.

Worlds of 1, 2 and 4 gloo ranks (data x rows = 1 x 1, 2 x 1, 2 x 2) run
`dryrun_multichip` in spawned processes (tests/test_torch_parallel_worker.py,
no JAX there). Tolerances: the mesh step's loss within 1e-6 relative and
its updated parameters within 1e-6 absolute of the no-mesh step (the
function's own check, repeated here); the loss within rtol 1e-5 of the
JAX `loss_fn` of `__graft_entry__.py:133-140` on the same data and
parameters (two f32 programs with their own reduction orders); the
flat-mesh checks within the JAX function's tolerances; the
differentiable psum's gradient within 1e-6 of the one-process gradient.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.models.trainable_jacobi import (
    TrainableJacobiMLP as JMLP, jacobi_diag_features_banded as j_feats)
from gnnla_tpu.ops.dia import DIAOperator as JDIA
from gnnla_tpu.ops.pallas_stencil import stencil_taps as j_stencil_taps
from gnnla_tpu.parallel import stencil_scaling_model as j_stencil_model
from gnnla_tpu.problems import laplacian_2d as j_laplacian
from gnnla_tpu.training import spectral_loss as j_sl
from gnnla_tpu.training.checkpoints import load_params_npz as j_load
from gnnla_tpu.training.datasets import small_band_dataset as j_small_band
from gnnla_tpu_torch.models.trainable_jacobi import TrainableJacobiMLP
from gnnla_tpu_torch.parallel.dryrun import mesh_shape
from gnnla_tpu_torch.training.checkpoints import save_params_npz

import test_torch_parallel_worker as W

WORLDS = (1, 2, 4)
SUITE = "dryrun"
LINE = re.compile(
    r"dryrun_multichip\((\d+)\): train-step loss (\d+\.\d{5}), sharded "
    r"jacobi \+ vcycle \+ multigrid-cycle \+ stencil \+ stream \+ "
    r"stream-vcycle ok \(mesh data=(\d+) x rows=(\d+)\); modeled "
    r"stencil-SpMV scaling at 2048\^2 on (\d+) chips: \d+\.\d% serial / "
    r"\d+\.\d% overlapped \(halo (\d+) KiB/chip vs local (\d+\.\d) "
    r"MiB/chip\); sharded stream \(general graph, halo (\d+) tiles\): "
    r"\d+\.\d% serial / \d+\.\d% overlapped at n=(\d+), \d+\.\d% serial "
    r"at n=1M$")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("dryrun"))
    ctxs = {S: W.start(SUITE, S, run_dir) for S in WORLDS}
    return run_dir, {S: W.join(ctx, 120) for S, ctx in ctxs.items()}


def res(ranks, S, case, rank=0):
    return W.result(ranks[0], SUITE, S, case, rank)


def params_of(r, prefix):
    return {k.split(":", 1)[1]: v for k, v in r.items()
            if k.startswith(prefix + ":")}


@pytest.mark.parametrize("S", WORLDS)
def test_ranks_ran(ranks, S):
    assert ranks[1][S] is None, ranks[1][S]


@pytest.mark.parametrize("S", WORLDS)
def test_mesh_step_equals_no_mesh(ranks, S):
    """Every rank's loss within 1e-6 of the no-mesh step's, its updated
    parameters within 1e-6, and all ranks alike."""
    first = params_of(res(ranks, S, "dryrun"), "param")
    for rank in range(S):
        r = res(ranks, S, "dryrun", rank)
        assert tuple(r["mesh"]) == mesh_shape(S)
        np.testing.assert_allclose(r["loss"], r["reference_loss"],
                                   rtol=1e-6)
        got, want = params_of(r, "param"), params_of(r, "reference")
        assert got.keys() == want.keys() and got
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


def test_step_loss_matches_jax_loss_fn(ranks, tmp_path):
    """`__graft_entry__.py:133-140`'s loss_fn on the dry run's data for
    each world, at the port's initial parameters (carried into the flax
    tree through the npz format both packages read)."""
    model = JMLP()
    template = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 5)))
    path = str(tmp_path / "init.npz")
    save_params_npz(path, TrainableJacobiMLP(generator=0, device="cpu"))
    params = j_load(path, template)
    for S in WORLDS:
        B = 2 * mesh_shape(S)[0]
        ds = j_small_band(B, n=8, seed=0, cache_dir=None)
        n_v = ds.template.n_rows
        rng = np.random.default_rng(0)
        probes = np.stack([j_sl.high_freq_probes(n_v, 4, ds.coords[i], rng)
                           for i in range(B)])
        dia_offsets, dia_diags = ds.dia_stack()
        n_rows, nnz = ds.template.n_rows, ds.template.nnz
        blay, band_stack = ds.band_stack_nodiag()
        f_mask = jnp.asarray(blay.mask)
        f_deg = jnp.asarray(np.maximum(blay.deg, 1), jnp.float32)

        def loss_fn(params, dia_vals, band_ov, diags, probes):
            def one(dd, bo, d, y):
                feats = j_feats(d, bo, f_mask, f_deg)
                dvals = jnp.ravel(model.apply(params, feats))
                op = JDIA(diags=dd, offsets=dia_offsets, n=n_rows, nnz=nnz)
                return j_sl.damping_factor_gelfand(op, dvals, 2.0 / 3.0, y,
                                                   k=3)
            return jnp.mean(jax.vmap(one)(dia_vals, band_ov, diags, probes))

        f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        want = float(loss_fn(params, f32(dia_diags), f32(band_stack),
                             f32(ds.diags), f32(probes)))
        np.testing.assert_allclose(res(ranks, S, "dryrun")["loss"], want,
                                   rtol=1e-5, err_msg=f"S={S}")


@pytest.mark.parametrize("S", WORLDS)
def test_flat_checks_and_line(ranks, S):
    """The flat-mesh checks within the JAX function's tolerances; rank 0
    alone prints the JAX function's line, with this world's mesh, loss,
    sizes and the JAX stencil model's byte counts."""
    r = res(ranks, S, "dryrun")
    # the function raises past the JAX tolerances; the errors it kept
    assert all(np.isfinite(float(r[k])) for k in (
        "stencil_max_abs_err", "stream_max_abs_err",
        "stream_vcycle_max_abs_err"))
    assert int(r["k2_launches"]) == 0  # the plain version runs on the CPU
    line = str(r["line"])
    assert str(r["printed"]).strip() == line
    for rank in range(1, S):
        assert str(res(ranks, S, "dryrun", rank)["printed"]) == ""
    m = LINE.fullmatch(line)
    assert m, line
    dp, rows = mesh_shape(S)
    assert (int(m[1]), int(m[3]), int(m[4]), int(m[5])) == (S, dp, rows, S)
    assert m[2] == f"{float(r['loss']):.5f}"
    ng = 4 * S
    shifts, _ = j_stencil_taps(j_laplacian(ng), (ng, ng))
    jm = j_stencil_model(2048, 2048, len(shifts), S)
    assert int(m[6]) == round(jm["comm_bytes_per_chip"] / 1024)
    assert m[7] == f"{jm['local_bytes_per_chip'] / 1024 ** 2:.1f}"
    assert (int(m[8]), int(m[9])) == (int(r["h_tiles"]), 2048 * S)
    assert "need" in str(r["wrong_world"])


@pytest.mark.parametrize("S", WORLDS)
def test_psum_replicated_gives_the_one_process_gradient(ranks, S):
    """Each rank's rows of the gradient of a loss built on the
    differentiable psum equal the one-process gradient's rows."""
    r0 = res(ranks, S, "psum_replicated")
    v = torch.from_numpy(r0["v"]).requires_grad_(True)
    loss = torch.amax(torch.linalg.vector_norm(v, dim=0)) ** (1.0 / 3.0)
    loss.backward()
    for rank in range(S):
        r = res(ranks, S, "psum_replicated", rank)
        np.testing.assert_allclose(r["loss"], float(loss.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(r["grad"],
                                   v.grad[rank * 8:(rank + 1) * 8].numpy(),
                                   rtol=1e-6, atol=1e-7)
