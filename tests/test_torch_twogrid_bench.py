"""The benchmark's two-grid deployment on the CPU at 64^2: the port's
`setup_auto` stencil leg, handed -A and -b as the two-grid driver hands
them (`perfbench/drivers/twogrid.py`), against the plain reference
(`perfbench/reference/twogrid.py`: its own strength, direct interpolation
and P^T A P from A and the port's C/F splitting, and `runVCycle`, in
float64).

Tolerance on x after five cycles: max|x - x_ref| / max|x_ref| <= 1e-5.
The port runs in float32, so each cycle rounds at 2^-24 (6e-8) relative
and the Chebyshev and Jacobi steps amplify that by their norms; it reads
about 2e-7 here. The reference computed in bfloat16 (2^-8 rounding) reads
about 5e-3 and must fail it.
"""

import numpy as np
import pytest
import torch

from gnnla_tpu_torch.models.vcycle import setup_auto
from gnnla_tpu_torch.ops.sparse import SparseOperator
from perfbench.problems.poisson_fd import poisson_fd
from perfbench.reference.sparse import Reference
from perfbench.reference.twogrid import TwoGrid

N = 64
N_CYCLES = 5
X_TOL = 1e-5
CYCLE = dict(n_pre=3, n_post=3, omega=0.7, coarse_deg=4, coarse_c=-3.4,
             coarse_d=-4.0)


def _port(sign):
    """(rows, cols, vals, n) of the SPD A, and the port's solver on
    sign * A, built through setup_auto on the CPU."""
    rows, cols, vals, n = poisson_fd([N, N])
    A = SparseOperator.from_coo(rows, cols, sign * vals, (n, n),
                                coalesce=False, device="cpu")
    auto = setup_auto(A, theta=0.25, splitting="cljp", seed=0, **CYCLE)
    return (rows, cols, vals, n), auto


@pytest.fixture(scope="module")
def handed_over():
    """The port on -A (the reference's convention), as the driver runs it,
    the reference on the same -A and the set-up's C/F splitting, and a
    b."""
    (rows, cols, vals, n), auto = _port(-1)
    ref = _reference(auto, rows, cols, vals, n)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(n)
                         .astype(np.float32))
    return (rows, cols, vals, n), auto, ref, b


def _reference(auto, rows, cols, vals, n, dtype=torch.float64):
    return TwoGrid((rows, cols, -vals), auto.setup.coarse_flags.numpy(), n,
                   "cpu", dtype, theta=0.25, **CYCLE)


def _rel(x, x_ref):
    return float((x.double() - x_ref).abs().max() / x_ref.abs().max())


def test_stencil_leg_matches_the_reference_cycle(handed_over):
    (rows, cols, vals, n), auto, ref, b = handed_over
    assert auto.layout == "stencil"
    x = auto.solve(-b, torch.zeros(n), n_cycles=N_CYCLES)
    assert _rel(x, ref.solve(-b, N_CYCLES)) <= X_TOL


def test_the_reference_in_bfloat16_fails_the_tolerance(handed_over):
    (rows, cols, vals, n), auto, ref, b = handed_over
    control = _reference(auto, rows, cols, vals, n, torch.bfloat16)
    x16 = control.solve(-b, N_CYCLES)
    assert x16.dtype == torch.bfloat16
    assert _rel(x16, ref.solve(-b, N_CYCLES)) > 10 * X_TOL


def test_the_hand_over_keeps_x(handed_over):
    """The port on (-A, -b) gives the x of the SPD system A x = b that the
    reference's cycle gives in its own convention: the true residual of
    the SPD system is the reference's, and it falls with every cycle. The
    same cycle on (A, b) as given diverges: the Chebyshev constants
    c -3.4, d -4.0 assume the reference's negative convention."""
    (rows, cols, vals, n), auto, ref, b = handed_over
    spd = Reference(rows, cols, vals, n, "cpu")
    res = [spd.rel_residual(b, auto.solve(-b, torch.zeros(n), n_cycles=k))
           for k in range(1, N_CYCLES + 1)]
    assert all(r1 < r0 < 1.0 for r0, r1 in zip(res, res[1:]))
    assert res[-1] == pytest.approx(
        spd.rel_residual(b, ref.solve(-b, N_CYCLES)), rel=1e-5)
    _, as_given = _port(+1)
    x = as_given.solve(b, torch.zeros(n), n_cycles=N_CYCLES)
    assert spd.rel_residual(b, x) > 1.0


def test_the_reference_galerkin_product_is_the_ports_ac(handed_over):
    """The reference's own P^T A P in float64, from A and its own P,
    against the set-up's float32 Ac: the same pattern, values within one
    float32 rounding, and Ac as the stencil cycle applies it (its DIA
    twin) within float32 sums."""
    _, auto, ref, b = handed_over
    Ac = auto.setup.Ac
    rows, cols, vals = Ac.host_coo()
    want = ref.Ac_product
    idx = want.indices().numpy()
    assert np.array_equal(np.stack([rows, cols]), idx)
    scale = float(want.values().abs().max())
    err = np.abs(vals.astype(np.float64) - want.values().numpy()).max()
    assert err <= 2.0 ** -24 * scale
    v = b[:Ac.n_rows]
    y = auto._stencil.setup.Ac.matvec(v)
    assert ref.galerkin_rel_err(v, y) <= X_TOL


def test_the_reference_builds_the_ports_p(handed_over):
    """Strength and direct interpolation, rebuilt by the reference in
    float64 from A and the port's C/F splitting, give the set-up's P
    within one float32 rounding of its largest entry (2^-24); the weights
    here, 1/4 and 1, are exact in float32, so it reads 0. A P whose
    interpolation weights are off by 1% fails that, and so does another
    coarse grid."""
    _, auto, ref, _ = handed_over
    P = auto.setup.P
    rows, cols, vals = P.host_coo()
    assert ref.p_rel_err((rows, cols, vals), P.shape) <= 2.0 ** -24
    off = np.where(vals < 1.0, vals * 1.01, vals)
    assert ref.p_rel_err((rows, cols, off), P.shape) > 1e-3
    assert ref.p_rel_err((rows, cols, vals), (P.shape[0], P.shape[1] + 1)) \
        == float("inf")


TG_SETUP = ("tg.strength", "tg.split", "tg.interp", "tg.galerkin")
TG_CYCLE = ("tg.pre", "tg.residual", "tg.restrict", "tg.coarse",
            "tg.prolong", "tg.post")


def test_the_set_up_records_its_stages():
    """setup_twogrid's four steps and the stencil leg's taps and layouts
    are stages, once each, within the set-up's wall time."""
    import time

    from gnnla_tpu_torch.utils import program as prog

    prog.reset()
    t0 = time.perf_counter()
    _port(-1)
    wall = time.perf_counter() - t0
    rep = prog.report()
    prog.reset()
    stages = TG_SETUP + ("tg.taps", "tg.layout")
    assert [rep[s]["calls"] for s in stages] == [1] * len(stages)
    assert sum(rep[s]["host_s"] for s in stages) <= wall


@pytest.mark.parametrize("leg", ["stencil", "plain"])
def test_a_profiled_cycle_leaves_the_tg_spans(handed_over, leg):
    """Under a profiler a cycle of either form (StencilVCycle.cycle,
    vcycle on the plain setup) is the span tg.cycle holding its six
    steps, once each."""
    from torch.profiler import ProfilerActivity, profile

    from gnnla_tpu_torch.models.vcycle import vcycle
    from gnnla_tpu_torch.utils import program as prog

    _, auto, _, b = handed_over
    x0 = torch.zeros_like(b)
    prog.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        if leg == "stencil":
            auto.run(-b, x0)
        else:
            vcycle(auto.setup, -b, x0, **CYCLE)
    rep = prog.report()
    prog.reset()
    assert (rep["tg.cycle"]["calls"], rep["tg.cycle"]["parent"]) == (1, None)
    for name in TG_CYCLE:
        assert (rep[name]["calls"], rep[name]["parent"]) == (1, "tg.cycle")
