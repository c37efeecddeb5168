"""Data-parallel training in the port (`train_jacobi` and
`train_diffusion` with a "data" mesh or n_devices) against the JAX
package's `n_devices` runs on the CPU.

The port runs S = 2 and 4 gloo ranks (spawned once per world size for the
whole module, tests/test_torch_parallel_worker.py), each from the JAX
package's initial parameters (`params_from_jax`,
`diffusion_params_from_jax`); JAX trains the same configurations with
n_devices = S on the forced CPU devices. Losses within 1e-4 of JAX's (its
own bound for `test_train_*_data_parallel_parity`, tests/test_training.py)
and within 1e-5 of the port's run without a mesh.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from gnnla_tpu.models import diffusion_gnn as j_dg
from gnnla_tpu.models import trainable_jacobi as j_tj
from gnnla_tpu.training import datasets as j_ds
from gnnla_tpu_torch.training.checkpoints import (diffusion_params_from_jax,
                                                  params_from_jax)
from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset

from test_torch_diffusion import jax_init
import test_torch_parallel_worker as W

j_train = importlib.import_module("gnnla_tpu.training.train_jacobi")
t_train = importlib.import_module("gnnla_tpu_torch.training.train_jacobi")
j_train_d = importlib.import_module("gnnla_tpu.training.train_diffusion")
t_train_d = importlib.import_module(
    "gnnla_tpu_torch.training.train_diffusion")

WORLDS = (2, 4)
SUITE = "train"
MODEL = {k: W.TRAIN_DIFFUSION[k] for k in (
    "n_layers_external", "n_layers_internal", "n_hidden", "encoder")}


@pytest.fixture(scope="module")
def inits():
    """The JAX package's initial parameters of both runs, as the port's
    state dicts."""
    pj = j_tj.init_params(jax.random.PRNGKey(0))
    jd = j_ds.cosine_diffusion_dataset(16, n=8, seed=41)
    pd = jax_init(j_dg.DiffusionGNN(**MODEL), jd, 41, 8)
    return (pj, params_from_jax(pj),
            diffusion_params_from_jax(jax.tree.map(np.asarray, pd)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inits):
    run_dir = tmp_path_factory.mktemp("parallel_train")
    torch.save(inits[1], run_dir / "jacobi_init.pt")
    torch.save(inits[2], run_dir / "diffusion_init.pt")
    ctxs = {S: W.start(SUITE, S, str(run_dir)) for S in WORLDS}
    return str(run_dir), {S: W.join(ctx, 120) for S, ctx in ctxs.items()}


def res(ranks, S, rank=0):
    return W.result(ranks[0], SUITE, S, "train", rank)


def history(h):
    return {k: np.asarray(h[k], np.float64)
            for k in ("train_loss", "val_loss", "test_loss")}


@pytest.fixture(scope="module")
def port_single(inits):
    """The port's runs without a mesh, from the same parameters."""
    _, hj = t_train.train(t_train.TrainJacobiConfig(**W.TRAIN_JACOBI),
                          init_params=inits[1], device="cpu")
    ds = cosine_diffusion_dataset(16, n=8, seed=41, device="cpu")
    _, hd = t_train_d.train(t_train_d.TrainDiffusionConfig(
        **W.TRAIN_DIFFUSION), dataset=ds, init_params=inits[2],
        device="cpu")
    return history(hj), history(hd)


@pytest.mark.parametrize("S", WORLDS)
def test_ranks_ran_alike(ranks, S):
    """Every rank ended well and holds the same histories."""
    assert ranks[1][S] is None, ranks[1][S]
    r0 = res(ranks, S)
    for r in range(1, S):
        other = res(ranks, S, r)
        for k in r0:
            if k != "seconds":
                np.testing.assert_array_equal(other[k], r0[k], err_msg=k)


@pytest.mark.parametrize("S", WORLDS)
def test_train_jacobi_data_parallel_matches_jax(ranks, S, inits,
                                                port_single):
    """3 epochs, batch 8 split over S ranks: the train, validation and
    test losses within 1e-4 of JAX's n_devices = S run and within 1e-5 of
    the port's run without a mesh; n_devices = S (the process group)
    gives the mesh's run."""
    got = res(ranks, S)
    _, hj = j_train.train(j_train.TrainJacobiConfig(
        **W.TRAIN_JACOBI, n_devices=S), init_params=inits[0])
    for k, want in history(hj).items():
        np.testing.assert_allclose(got[f"jacobi_{k}"], want, rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[f"jacobi_{k}"], port_single[0][k],
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[f"jacobi_nd_{k}"],
                                   got[f"jacobi_{k}"], rtol=1e-6, err_msg=k)
    assert got["jacobi_train_loss"][-1] < got["jacobi_train_loss"][0]


@pytest.mark.parametrize("S", WORLDS)
def test_train_diffusion_data_parallel_matches_jax(ranks, S, port_single):
    """2 epochs of batch 4 at n = 8 over S ranks (the penalty's max taken
    over the global batch): the losses within 1e-4 of JAX's n_devices = S
    run and within 1e-5 of the port's run without a mesh."""
    got = res(ranks, S)
    jd = j_ds.cosine_diffusion_dataset(16, n=8, seed=41)
    _, hj = j_train_d.train(j_train_d.TrainDiffusionConfig(
        **W.TRAIN_DIFFUSION, n_devices=S), dataset=jd)
    for k, want in history(hj).items():
        np.testing.assert_allclose(got[f"diffusion_{k}"], want, rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[f"diffusion_{k}"], port_single[1][k],
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("S", WORLDS)
def test_indivisible_batch_refused(ranks, S):
    """A batch the ranks do not divide: ValueError in both packages."""
    bad = dict(W.TRAIN_JACOBI, batch_size=2 * S + 1)
    with pytest.raises(ValueError, match="divisible"):
        j_train.train(j_train.TrainJacobiConfig(**bad, n_devices=S))
    got = str(res(ranks, S)["indivisible"])
    assert got.startswith("ValueError: batch_size") and "divisible" in got
