"""The port's example twins (`gnnla_tpu_torch/examples/`) against the JAX
package's examples on the CPU, at `tests/test_examples.py`'s SMALL sizes:
each twin runs with device="cpu" and the numbers it prints, line by line,
match the numbers the JAX example prints within the tolerance stated per
example in TOL. The two training examples start the port from the JAX
package's initial parameters (their generators differ).
"""

import importlib
import os
import re
import sys

import numpy as np
import pytest

from test_examples import SMALL
from test_torch_cli import diffusion_from_jax_init, jacobi_from_jax_init

_EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
NUMBER = re.compile(r"-?\d+\.?\d*(?:e[+-]?\d+)?")
TWINS = sorted(SMALL)

# (rtol, atol) per example. "errors": relative or absolute errors of an f32
# computation against float64 or another f32 path, of order 1e-7 in both
# packages (the packages round differently, so only their size compares).
TOL = {
    "matvec": (0.0, 1e-5),           # errors only
    "residual_norm": (1e-5, 1e-5),   # an error; norms printed to 1e-6
    "jacobi": (1e-4, 1e-6),          # an error; |r| after 10-100 f32 sweeps
    "chebyshev": (0.0, 1e-5),        # errors only
    "power_method": (1e-5, 0.0),     # lambdas printed to 1e-6
    "soc_interp": (0.0, 1e-6),       # exact counts, an exact 0
    # |r| per cycle; the cycle loop against the solve (JAX: a lax.scan
    # that XLA compiles apart, 1e-5 off; the port: the same loop, 0)
    "vcycle": (1e-4, 1e-4),
    # sizes exact, cycle |r| to 1e-4; the CG/PCG residuals end near the
    # f32 rounding of |b| (~1e-6 |b|, |b| ~ 9), which differs by package
    "multigrid_pcg": (1e-4, 1e-4),
    # losses printed to 5 decimals from the same initial parameters and
    # data (the packages' losses agree to ~1e-6); damping factors to 4
    "train_jacobi": (0.0, 2e-4),
    "train_diffusion": (0.0, 1e-4),
    # counts exact; errors of f32 paths (the diffusion forwards' depends
    # on the parameters, drawn by each package's own generator)
    "band_layout": (0.0, 1e-4),
    "unstructured_ell": (0.0, 1e-5),
    # both at one rank (JAX: a 1-device mesh; the port: a gloo world of
    # one): sizes and counts exact, lambdas printed to 1e-6, errors of
    # order 1e-8, the mg_pcg residual printed to 3 digits (1.76e-03)
    "distributed": (1e-5, 1e-5),
}


def numbers(out: str):
    """The numbers of each printed line; the Jacobi trainer's epoch
    seconds "(0.1s)" are dropped."""
    return [[float(v) for v in NUMBER.findall(re.sub(r"\([\d.]+s\)", "",
                                                        ln))]
            for ln in out.strip().splitlines()]


def test_twins_cover_the_single_device_examples():
    from gnnla_tpu_torch.examples import run_all
    assert sorted(run_all.MODULES) == TWINS
    assert set(TOL) == set(TWINS)


@pytest.mark.parametrize("name", TWINS)
def test_twin_prints_the_jax_numbers(name, capsys, monkeypatch):
    if name == "distributed":
        # the JAX example meshes every device; the port's runs alone as
        # one rank, so the JAX one sees one device
        import jax
        devices = jax.devices
        monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    sys.path.insert(0, _EXAMPLES_DIR)
    try:
        importlib.import_module(name).main(**SMALL[name])
    finally:
        sys.path.remove(_EXAMPLES_DIR)
    want = numbers(capsys.readouterr().out)
    twin = importlib.import_module(f"gnnla_tpu_torch.examples.{name}")
    if name == "train_jacobi":
        monkeypatch.setattr(twin, "train", jacobi_from_jax_init(twin.train))
    if name == "train_diffusion":
        monkeypatch.setattr(twin, "train",
                            diffusion_from_jax_init(twin.train))
    twin.main(**SMALL[name], device="cpu")
    got = numbers(capsys.readouterr().out)
    assert len(got) == len(want)
    rtol, atol = TOL[name]
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (i, g, w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"line {i}")


def test_run_all_on_the_cpu(capsys):
    """run_all with --device cpu runs all twelve and reports each."""
    from gnnla_tpu_torch.examples import run_all
    assert run_all.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(" ok (") == len(TWINS)
    assert f"{len(TWINS)}/{len(TWINS)} examples passed" in out


def test_twins_need_a_card_unless_told(monkeypatch, capsys):
    """Without a card each twin stops with the no-card message, and
    run_all reports the failures and returns 1."""
    import torch

    from gnnla_tpu_torch.examples import run_all, vcycle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vcycle.main(n=10, n_cycles=1)
    assert run_all.main([]) == 1
    assert f"0/{len(TWINS)} examples passed" in capsys.readouterr().out
