"""The port's committed results (`artifacts_torch/`): the printed result
lines of the `gnnla_tpu_torch.scripts` twins from their full-scale run on
the card, held to the claims `tests/test_artifacts.py` holds the JAX
package's TPU artifacts to, within the stated bands, and to the data-only
numbers of `artifacts/` (the baselines within 1e-5 relative and the
omega = 2/3 two-grid rho within 1e-6: tests/test_torch_reproduce.py
measured the JAX-CPU gaps at most 2.9e-9 and 0). PERF.md's H100 block is
rendered from these files.
"""

import json
import os
import re

import numpy as np
import pytest

from gnnla_tpu_torch.scripts import gen_results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "artifacts_torch")
JAX = os.path.join(ROOT, "artifacts")
FILES = ("jacobi/results.json", "jacobi/results_stable.json",
         "jacobi/smoother_twogrid.json", "diffusion/grid.json",
         "diffusion/results.json")
# the card's `name, power.limit` as nvidia-smi prints them
CARD = re.compile(r"NVIDIA [^,]+, \d+(\.\d+)? W")


def load(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


@pytest.mark.parametrize("rel", FILES)
def test_each_result_names_the_card(rel):
    assert CARD.fullmatch(load(PORT, rel)["device"]), rel


def test_jacobi_claims_and_baselines():
    r = load(PORT, "jacobi/results.json")
    assert r["config"]["epochs"] == 62 and r["config"]["num_matrices"] == 1000
    assert r["n_test_matrices"] == 150
    hf = r["highfreq_damping_mean"]
    assert hf["learned"] < hf["w23"]
    assert hf["learned"] < hf["w1"]
    assert hf["learned"] < hf["opt"] + 0.02
    assert abs(hf["learned"] - 0.531) <= 0.03
    want = load(JAX, "jacobi/results.json")
    for part in ("highfreq_damping_mean", "fullspectrum_damping_mean"):
        for k in ("w1", "w23", "opt"):
            np.testing.assert_allclose(r[part][k], want[part][k], rtol=1e-5,
                                       err_msg=f"{part}.{k}")


def test_stable_fine_tune_is_stable():
    r = load(PORT, "jacobi/results_stable.json")
    assert r["config"]["stability_weight"] == 1.0
    assert r["fullspectrum_damping_mean"]["learned"] < 1.05


def test_twogrid_closure():
    sm = load(PORT, "jacobi/smoother_twogrid.json")
    want = load(JAX, "jacobi/smoother_twogrid.json")
    assert sm["n_matrices"] == 30
    assert sm["convfac_learned_mean"] > 1.0  # the documented divergence
    assert sm["convfac_stable_mean"] < 1.0
    assert sm["convfac_stable_mean"] < 1.05 * sm["convfac_w23_mean"]
    assert abs(sm["convfac_stable_mean"] - 0.666) <= 0.03
    for k in ("convfac_w23_mean", "convfac_w23_max"):
        np.testing.assert_allclose(sm[k], want[k], rtol=1e-6, err_msg=k)


def test_grid():
    g = load(PORT, "diffusion/grid.json")
    vals = [c["val_loss"] for c in g["combos"]]
    assert len(vals) == 5
    assert g["best_index"] == int(np.argmin(vals))
    assert all(0.0 < v < 1.0 for v in vals)
    assert min(vals) <= 2 * 0.00431


def test_diffusion_claims():
    r = load(PORT, "diffusion/results.json")
    assert r["config"]["num_matrices"] == 1000 and r["config"]["n_mesh"] == 80
    assert r["test_loss"] <= 1.5 * 0.00272
    ood = np.asarray(list(r["ood_loss_by_decade"].values()))
    assert len(ood) == 6 and (ood < 0.02).all()
    assert ood.max() / ood.min() <= 2.0
    assert r["freq_study_mean_err"] <= 0.0069


def test_perf_md_h100_block_matches_the_results():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        text = f.read()
    assert gen_results.BEGIN in text and gen_results.END in text
    block = text.split(gen_results.BEGIN, 1)[1].split(gen_results.END, 1)[0]
    assert block == "\n" + gen_results.render()
