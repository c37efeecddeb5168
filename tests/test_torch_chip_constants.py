"""The JAX-package reference values that `chip_smoke.py`'s diffusion and
two-grid phases hold the card to, and how they were made.

`chip_smoke.py` never imports JAX, so the values it needs from the JAX
package (the committed diffusion model's test loss, OOD sweep and
frequency study at n = 80; the committed Jacobi parameters' mean two-grid
rho, learned and stable, over the first 30 test matrices: all computed by
`gnnla_tpu` on the CPU) are constants in the script. Regenerate them with

    JAX_PLATFORMS=cpu python tests/test_torch_chip_constants.py [CACHE_DIR]

(about 5 minutes on 8 cores; the 1000-matrix dataset is cached in
CACHE_DIR, default `data_cache`), which prints the five constants to
paste into `chip_smoke.py`. The tier-1 tests below recompute the OOD
sweep and the two rho means and hold the script's constants to them.
"""

import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from gnnla_tpu.core import GraphState
from gnnla_tpu.evaluation.freq_study import freq_study_errors
from gnnla_tpu.evaluation.ood import ood_extrapolation
from gnnla_tpu.models.diffusion_gnn import DiffusionGNN
from gnnla_tpu.training.checkpoints import load_params_npz
from gnnla_tpu.training.datasets import cosine_diffusion_dataset

from test_torch_reproduce import (committed_jacobi_params,
                                  jax_jacobi_test_split, jax_twogrid_rhos)

j_train = importlib.import_module("gnnla_tpu.training.train_diffusion")

ARTIFACT = "artifacts/diffusion"
N = 80
CFG = dict(n_layers_external=1, n_layers_internal=2, n_hidden=32,
           encoder=(3, 16))


def artifact_model(ds):
    """The committed model and its parameters (template from `ds`)."""
    model = DiffusionGNN(**CFG)
    rel = j_train.edge_features(ds, N)
    e0 = jnp.concatenate([jnp.asarray(ds.offdiag_vals[0], jnp.float32)[
        :, None], jnp.asarray(rel, jnp.float32)], axis=1)
    s0 = GraphState(vertices=jnp.asarray(ds.diags[0], jnp.float32)[:, None],
                    edges=e0, globals_=jnp.asarray(ds.globals_[0],
                                                   jnp.float32))
    template = model.init(jax.random.PRNGKey(0), ds.template_nodiag, s0)
    return model, load_params_npz(f"{ARTIFACT}/params.npz", template)


def ood_reference(model, params):
    return [float(x) for x in ood_extrapolation(params, model, n=N)["loss"]]


def test_chip_smoke_ood_constant_is_the_jax_value():
    import chip_smoke

    ds = cosine_diffusion_dataset(1, n=N, seed=41)
    model, params = artifact_model(ds)
    np.testing.assert_allclose(chip_smoke.JAX_CPU_OOD_LOSS,
                               ood_reference(model, params), rtol=1e-6)


def twogrid_references() -> dict:
    """The mean cycle rho of the committed learned and stable Jacobi
    parameters over the first 30 test matrices (the smoother phase's)."""
    rho = jax_twogrid_rhos(jax_jacobi_test_split(30), 30, {
        "learned": committed_jacobi_params(),
        "stable": committed_jacobi_params("params_stable.npz")})
    return {"JAX_CPU_CONVFAC_LEARNED_MEAN": float(rho["learned"].mean()),
            "JAX_CPU_CONVFAC_STABLE_MEAN": float(rho["stable"].mean())}


def test_chip_smoke_twogrid_constants_are_the_jax_values():
    import chip_smoke

    for name, want in twogrid_references().items():
        np.testing.assert_allclose(getattr(chip_smoke, name), want,
                                   rtol=1e-9, err_msg=name)


def references(cache_dir: str) -> dict:
    """All three constants, from the JAX package on the CPU."""
    ds = cosine_diffusion_dataset(1000, n=N, max_freq=3.0, seed=41,
                                  cache_dir=cache_dir)
    model, params = artifact_model(ds)
    # the test split as `train` derives it (70/20/10 of a seed-41 perm)
    perm = np.random.default_rng(41).permutation(ds.n_graphs)
    te = ds.select(perm[900:])
    apply_fn, pack = j_train.make_apply_banded(model, ds,
                                               j_train.edge_features(ds, N),
                                               grid_shape=(N, N))
    apply_fn = jax.jit(apply_fn)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    preds = jnp.concatenate([
        apply_fn(params, f32(pack(te.offdiag_vals[i:i + 20])),
                 f32(te.diags[i:i + 20]), f32(te.globals_[i:i + 20]))
        for i in range(0, te.n_graphs, 20)])
    test_loss = float(j_train.loss_terms(preds, f32(te.targets)))
    _, errors = freq_study_errors(params, model, n=N, max_freq=4.0)
    return {"JAX_CPU_TEST_LOSS": test_loss,
            "JAX_CPU_OOD_LOSS": ood_reference(model, params),
            "JAX_CPU_FREQ_ERRORS": errors.tolist(), **twogrid_references()}


if __name__ == "__main__":
    print(json.dumps(references(sys.argv[1] if len(sys.argv) > 1
                                else "data_cache"), indent=1))
