"""Two-grid AMG V-cycle — the counterpart of gnnla_tpu/models/vcycle.py.

AMG setup runs once on the host (`setup_twogrid`: strength of connection,
C/F splitting, direct interpolation, Galerkin product) and returns a
`TwoGridSetup` of fixed-pattern operators on one device; `vcycle` is then
Jacobi pre-smoothing, restriction of the residual, a Chebyshev coarse
solve, prolongation of the correction and Jacobi post-smoothing. `solve`
iterates cycles in a Python loop (the JAX package's `lax.scan`); the
classes' `run`/`solve` run as programs (`utils/program.py`, the twin of
`jax.jit`): one captured CUDA graph on the card.

Fast path: `setup_with_dia(setup, kernel=True)` puts A and Ac on kernel
K1 (the DIA SpMV), `setup_with_stream_p` puts P and P^T on kernel K2 (the
CSR SpMV), and `setup_with_stream` puts an unstructured A on K2 in RCM
order. Every solver only uses the matvec/rmatvec/diagonal protocol, so the
same `vcycle` runs on any of them.

Grid path: `StencilVCycle` runs the fine level of a cycle (pre-smoothing,
residual, post-smoothing) on kernel K4, the fused stencil, and on the card
Ac on K1 and P on K2. `AutoTwoGrid` /
`setup_auto` pick the fastest layout an operator admits (stencil > dia >
stream > coo); `models/geometric.py::GeometricVCycle` is the all-stencil
semi-coarsened cycle.

`setup_from_numpy` builds a setup from plain numpy arrays — the way a
setup made elsewhere (for instance by the JAX package, or one carrying a
trained Jacobi diagonal) is carried across.

Tracing (`utils/program.py`): each step of `setup_twogrid` is a stage
(`tg.strength`, `tg.split`, `tg.interp`, `tg.galerkin`), and so are
`StencilVCycle`'s taps and layouts (`tg.taps`, `tg.layout`); a cycle is
the span `tg.cycle`, and its parts the spans `tg.pre`, `tg.residual`,
`tg.restrict`, `tg.coarse`, `tg.prolong` and `tg.post`, in `vcycle` and
in `StencilVCycle.cycle` alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.amg.galerkin import galerkin_product
from gnnla_tpu_torch.amg.interp import assemble_prolongation
from gnnla_tpu_torch.amg.splitting import split
from gnnla_tpu_torch.models.chebyshev import chebyshev
from gnnla_tpu_torch.models.direct_interp import direct_interp
from gnnla_tpu_torch.models.jacobi import jacobi
from gnnla_tpu_torch.models.residual import residual
from gnnla_tpu_torch.models.soc import soc_classic
from gnnla_tpu_torch.ops.dia import DIAOperator, to_dia
from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator, dia_twin
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stencil import stencil_classes
from gnnla_tpu_torch.ops.stencil_kernel import (make_stencil_jacobi,
                                                make_stencil_residual)
from gnnla_tpu_torch.ops.stream_op import (rect_stream_operator,
                                           stream_operator)
from gnnla_tpu_torch.utils.program import program, span, stage


@dataclasses.dataclass(frozen=True)
class TwoGridSetup:
    """Fixed-pattern artifacts of the AMG setup phase, on one device."""

    A: Any    # SparseOperator | DIAOperator | DiaKernelOperator |
              # StreamOperator
    P: Any    # SparseOperator | RectStreamOperator
    Ac: Any   # SparseOperator | DIAOperator | DiaKernelOperator
    diag: torch.Tensor          # diag(A) — or a trained Jacobi diagonal
    coarse_flags: torch.Tensor  # [N] 1/0


def _soc_classic_host(rows, cols, vals, n, theta):
    """Classical strength of connection on the host (same empty-row
    semantics as the JAX twin: max over an empty row is 0). Returns the
    boolean strength mask per edge."""
    v = np.full(n, -np.inf, dtype=np.float64)
    np.maximum.at(v, rows, -vals)
    v[np.isneginf(v)] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        s = -vals / v[rows] - theta
    return np.nan_to_num(s, nan=-1.0, posinf=np.inf) > 0


def _direct_interp_raw(rows, cols, vals, diag, coarse, strong):
    """Direct interpolation weights in float64, divisions by zero left as
    inf/NaN (as the GN form's): w_ij = (1-C_i) * (-A_ij * alpha_i),
    alpha_i = (sum_k A_ik / sum_k A_ik S_ik C_k) / A_ii."""
    n = diag.shape[0]
    num = np.zeros(n, dtype=np.float64)
    den = np.zeros(n, dtype=np.float64)
    np.add.at(num, rows, vals)
    np.add.at(den, rows, vals * strong * coarse[cols])
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = (num / den) / diag
        return (1.0 - coarse[rows]) * (-vals * alpha[rows])


def _direct_interp_host(rows, cols, vals, diag, coarse, strong):
    """`_direct_interp_raw` with its non-finite weights zeroed: C rows
    contribute nothing; F rows with no strong C neighbour neither."""
    w = _direct_interp_raw(rows, cols, vals, diag, coarse, strong)
    return np.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)


def _direct_interp_host_signed(rows, cols, vals, diag, coarse, strong):
    """Stuben's signed direct interpolation (safe on non-M-matrices):
    positive off-diagonals are lumped into the diagonal, alpha uses the
    negative sums only, and rows are normalised by sign(diag) first. It
    reduces to `_direct_interp_host` on M-matrices."""
    n = diag.shape[0]
    sgn = np.where(diag < 0, -1.0, 1.0)
    vals = vals * sgn[rows]
    diag = diag * sgn
    neg = vals < 0
    keep = neg & (strong > 0)
    num = np.zeros(n, dtype=np.float64)
    den = np.zeros(n, dtype=np.float64)
    pos_sum = np.zeros(n, dtype=np.float64)
    np.add.at(num, rows, np.where(neg, vals, 0.0))
    np.add.at(den, rows, np.where(keep & (coarse[cols] > 0), vals, 0.0))
    np.add.at(pos_sum, rows, np.where(neg, 0.0, vals))
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = (num / den) / (diag + pos_sum)
        w = (1.0 - coarse[rows]) * np.where(keep, -vals * alpha[rows], 0.0)
    return np.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)


def setup_twogrid(A: SparseOperator, *, theta: float = 0.25,
                  splitting: str = "cljp", seed: int = 0,
                  diag: Optional[torch.Tensor] = None,
                  use_device_gnn: bool = False,
                  trunc: float = 0.0,
                  interp: str = "reference") -> TwoGridSetup:
    """AMG setup on the host: SOC -> C/F split -> direct interpolation ->
    Galerkin product (the stages `tg.strength`, `tg.split`, `tg.interp`,
    `tg.galerkin`). The operators land on A's device.

    `diag` substitutes a trained Jacobi diagonal for the smoother.
    interp="reference" is the reference formula, interp="signed" the
    Stuben variant for non-M-matrices. `use_device_gnn=True` runs SOC and
    the reference direct interpolation through the GN-block forms
    (`models/soc.py`, `models/direct_interp.py`) on A's device instead of
    numpy; the strength flags come to the host once for the splitting."""
    import scipy.sparse as sp

    device = A.device
    with stage("tg.strength"):
        A_nodiag = A.remove_diagonal()
        diag_h = A.host_diagonal()
        if diag is None:
            a_diag = torch.from_numpy(diag_h).to(A.vals.dtype).to(device)
        else:
            a_diag = torch.as_tensor(diag, device=device).reshape(-1)
        rows, cols, vals = A_nodiag.host_coo()
        if use_device_gnn:
            strong = (soc_classic(A_nodiag, theta) > 0).cpu().numpy()
        else:
            strong = _soc_classic_host(rows, cols, vals, A.n_rows, theta)
    with stage("tg.split"):
        S_host = sp.coo_matrix(
            (strong.astype(np.float64), (rows, cols)), shape=A.shape).tocsr()
        coarse = split(S_host, method=splitting, seed=seed)

    with stage("tg.interp"):
        if use_device_gnn:
            dtype = A.vals.dtype
            w_ij = direct_interp(
                A_nodiag, A.diagonal(),
                torch.from_numpy(coarse).to(device=device, dtype=dtype),
                torch.from_numpy(strong).to(device=device, dtype=dtype)
            ).cpu().numpy()
        else:
            interp_fn = {"reference": _direct_interp_host,
                         "signed": _direct_interp_host_signed}[interp]
            w_ij = interp_fn(rows, cols, vals, diag_h,
                             coarse.astype(np.float64),
                             strong.astype(np.float64))
        P = assemble_prolongation(A_nodiag, coarse, w_ij,
                                  dtype=A.vals.dtype, trunc=trunc)
    with stage("tg.galerkin"):
        Ac = galerkin_product(A, P)
    return TwoGridSetup(A=A, P=P, Ac=Ac, diag=a_diag,
                        coarse_flags=torch.from_numpy(coarse).to(device))


def setup_from_numpy(d: Mapping[str, Any], device="cuda") -> TwoGridSetup:
    """A TwoGridSetup from plain numpy arrays (e.g. an `np.load`ed .npz):

      {A,P,Ac}_rows, {A,P,Ac}_cols, {A,P,Ac}_vals  COO triplets
      {A,P,Ac}_shape                              (n_rows, n_cols)
      diag                                        [n] Jacobi diagonal —
                                                  diag(A) or a trained one
      coarse_flags                                [n] 1/0

    The operators are the plain COO ones; apply `setup_with_dia` /
    `setup_with_stream_p` for the kernel path."""
    device = resolve_device(device)

    def op(name):
        shape = tuple(int(s) for s in np.asarray(d[f"{name}_shape"]))
        return SparseOperator.from_coo(d[f"{name}_rows"], d[f"{name}_cols"],
                                       d[f"{name}_vals"], shape,
                                       device=device)

    return TwoGridSetup(
        A=op("A"), P=op("P"), Ac=op("Ac"),
        diag=torch.from_numpy(
            np.array(d["diag"], np.float32).reshape(-1)).to(device),
        coarse_flags=torch.from_numpy(
            np.array(d["coarse_flags"], np.int64).reshape(-1)).to(device))


def setup_with_dia(setup: TwoGridSetup, max_offsets: int = 512,
                   kernel: bool = False) -> TwoGridSetup:
    """Swap A (and Ac when banded enough) for DIA twins. `kernel=True`
    additionally puts both levels on kernel K1 (`DiaKernelOperator`), the
    counterpart of the JAX package's `pallas=True`. P stays as it is
    (rectangular; see `setup_with_stream_p`)."""
    return dataclasses.replace(setup,
                               A=dia_twin(setup.A, max_offsets, kernel),
                               Ac=dia_twin(setup.Ac, max_offsets, kernel))


def setup_with_stream_p(setup: TwoGridSetup) -> TwoGridSetup:
    """Swap the prolongation P for its kernel-K2 twin
    (`RectStreamOperator`: P and P^T as CSRs). Keeps the COO P exactly
    where the JAX package's packer refuses the pattern (ValueError), so
    composing with any setup is safe."""
    P = setup.P
    if not isinstance(P, SparseOperator):
        return setup  # already swapped
    try:
        P_s = rect_stream_operator(P, P.n_cols)
    except ValueError:
        return setup  # refused pattern — keep the COO path
    return dataclasses.replace(setup, P=P_s)


def setup_with_stream(setup: TwoGridSetup) -> TwoGridSetup:
    """Swap the fine operator A for its kernel-K2 twin in RCM order
    (`StreamOperator` with perm/iperm gathers) — the fast path for
    unstructured graphs, where `setup_with_dia` refuses or degrades. Ac
    stays COO. Raises ValueError where the JAX packer refuses the
    RCM-ordered pattern. The JAX package's `backend`/`interpret` options
    have no counterpart: the port has one backend."""
    if not isinstance(setup.A, SparseOperator):
        raise ValueError("setup.A already swapped; build the stream twin "
                         "from the COO setup")
    return dataclasses.replace(setup, A=stream_operator(setup.A))


def _coarse_layouts(setup: TwoGridSetup, coarse_dia: bool) -> TwoGridSetup:
    """The setup with StencilVCycle's coarse-correction operators: Ac as
    its DIA twin when `coarse_dia` and banded enough, and on a CUDA setup
    that twin on K1 and P on K2 (see StencilVCycle). On the card the
    twin's dense diagonals and K1's layouts are built on the host, and
    only the layouts go to the card: the cycle only applies Ac."""
    Ac = setup.Ac
    on_card = setup.A.device.type == "cuda"
    if coarse_dia and isinstance(Ac, SparseOperator):
        host = Ac if not on_card else SparseOperator(
            Ac.rows.cpu(), Ac.cols.cpu(), Ac.vals.cpu(), Ac.row_ptr.cpu(),
            Ac.shape, host_coo=Ac.host_coo())
        try:
            Ac = to_dia(host)
        except ValueError:
            pass  # too irregular — keep the COO path
    if not on_card:
        return dataclasses.replace(setup, Ac=Ac)
    if isinstance(Ac, DIAOperator):
        Ac = dia_kernel_operator(Ac, device=setup.A.device)
    return setup_with_stream_p(dataclasses.replace(setup, Ac=Ac))


class StencilVCycle:
    """Two-grid cycle with the fine level on kernel K4 (the fused stencil).

    For grid operators the fine-level work of a cycle — pre-smoothing,
    residual, post-smoothing — runs as three K4 calls (n_pre fused Jacobi
    sweeps, one fused r = b - A x, n_post fused sweeps). The coarse
    correction (P^T r -> Chebyshev on Ac -> P xc) runs on the setup's
    device: with `coarse_dia` Ac is swapped to its DIA twin when banded
    enough (the JAX package's `to_dia` swap). On a CUDA setup that twin
    runs on kernel K1 (`dia_kernel_operator`, its dense diagonals kept on
    the host and only K1's compact layouts on the card) and P on kernel
    K2 (`setup_with_stream_p`, which keeps the COO P where K2 refuses its
    pattern); on the CPU they stay the plain DIA twin and the COO P, as
    the JAX package runs them in XLA.

    Numerics match `vcycle(setup, ...)` with the same parameters: the
    smoother taps M = I - omega D^-1 A are built in float64 on the host,
    so only f32 rounding (and on the card K1's and K2's sum order)
    differs. The smoothing parameters are baked into the taps; build a
    new object to change them. The taps are the stage `tg.taps`, the
    coarse layouts the stage `tg.layout`.

    `cycle(b, x)` is one cycle op by op; `run(b, x)` runs it as a program
    (`self.program`, the JAX `_jit_cycle`): on the card a captured graph,
    replayed after the first call.

    Launches per cycle: n_pre + 1 + n_post K4 steps in three calls (3
    launches in the tile form), and on the card coarse_deg K1 launches on
    Ac and one K2 launch each for P^T and P."""

    def __init__(self, setup: TwoGridSetup, grid_shape, *, n_pre: int = 3,
                 n_post: int = 3, omega: float = 0.7, coarse_deg: int = 4,
                 coarse_c: float = -3.4, coarse_d: float = -4.0,
                 tap_dtype=None, coarse_dia: bool = True):
        if not isinstance(setup.A, SparseOperator):
            raise ValueError(
                "StencilVCycle builds its taps from the COO setup; "
                "construct it before setup_with_dia, not after")
        if min(n_pre, n_post) < 1:
            raise ValueError("n_pre and n_post must be >= 1")
        h, w = grid_shape
        self.grid_shape = (int(h), int(w))
        self._coarse = dict(c=coarse_c, d=coarse_d, deg=coarse_deg)
        with stage("tg.taps"):
            self._pre = make_stencil_jacobi(
                setup.A, self.grid_shape, omega=omega, n_iters=n_pre,
                diag=setup.diag, tap_dtype=tap_dtype)
            self._post = self._pre if n_post == n_pre else \
                make_stencil_jacobi(setup.A, self.grid_shape, omega=omega,
                                    n_iters=n_post, diag=setup.diag,
                                    tap_dtype=tap_dtype)
            self._res = make_stencil_residual(setup.A, self.grid_shape,
                                              tap_dtype=tap_dtype)
        with stage("tg.layout"):
            self.setup = _coarse_layouts(setup, coarse_dia)
        self.program = program(self.cycle)  # the JAX `_jit_cycle`

    def kernel_calls(self):
        """The distinct K4 calls of a cycle (their `launches` counters)."""
        calls = (self._pre._call, self._post._call, self._res._call)
        return list({id(c): c for c in calls}.values())

    def cycle(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One cycle on flat [n] vectors, op by op (capture-safe: no host
        synchronisation)."""
        P, Ac = self.setup.P, self.setup.Ac
        with span("tg.cycle"):
            b2 = b.reshape(self.grid_shape).float()
            with span("tg.pre"):
                x2 = self._pre.run(b2, x.reshape(self.grid_shape))
            with span("tg.residual"):
                r = self._res.run(b2, x2).reshape(-1)
            with span("tg.restrict"):
                rc = P.rmatvec(r)
            with span("tg.coarse"):
                xc = chebyshev(Ac, rc, torch.zeros_like(rc), **self._coarse)
            with span("tg.prolong"):
                x2 = x2 + P.matvec(xc).reshape(self.grid_shape)
            with span("tg.post"):
                return self._post.run(b2, x2).reshape(-1)

    def run(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One cycle on flat [n] vectors as a program (a captured graph
        on the card; see `utils/program.py`)."""
        return self.program(b.reshape(-1), x.reshape(-1))


def make_stencil_vcycle(setup: TwoGridSetup, grid_shape,
                        **kwargs) -> StencilVCycle:
    """Fused fine-level two-grid cycle for grid operators (see
    StencilVCycle)."""
    return StencilVCycle(setup, grid_shape, **kwargs)


def vcycle(setup: TwoGridSetup, b: torch.Tensor, x: torch.Tensor, *,
           n_pre: int = 3, n_post: int = 3, omega: float = 0.7,
           coarse_deg: int = 4, coarse_c: float = -3.4,
           coarse_d: float = -4.0) -> torch.Tensor:
    """One two-grid cycle. Defaults reproduce the reference (VCycle.py):
    w=0.7 Jacobi smoothing, degree-4 Chebyshev coarse solve with c=-3.4,
    d=-4.0. The cycle is the span `tg.cycle`, its steps the spans `tg.pre`,
    `tg.residual`, `tg.restrict`, `tg.coarse`, `tg.prolong`, `tg.post`."""
    A, P, Ac = setup.A, setup.P, setup.Ac
    b, x = b.reshape(-1), x.reshape(-1)
    with span("tg.cycle"):
        with span("tg.pre"):
            x = jacobi(A, b, x, omega=omega, n_iters=n_pre, diag=setup.diag)
        with span("tg.residual"):
            r = residual(A, b, x)
        with span("tg.restrict"):
            rc = P.rmatvec(r)
        with span("tg.coarse"):
            xc = chebyshev(Ac, rc, torch.zeros_like(rc), c=coarse_c,
                           d=coarse_d, deg=coarse_deg)
        with span("tg.prolong"):
            x = x + P.matvec(xc)
        with span("tg.post"):
            return jacobi(A, b, x, omega=omega, n_iters=n_post,
                          diag=setup.diag)


def solve(setup: TwoGridSetup, b: torch.Tensor, x: torch.Tensor, *,
          n_cycles: int, **cycle_kwargs) -> torch.Tensor:
    """Run n_cycles V-cycles (the JAX `lax.scan`: a plain function,
    capture-safe, which `program(solve)` runs as one graph)."""
    b, x = b.reshape(-1), x.reshape(-1)
    for _ in range(n_cycles):
        x = vcycle(setup, b, x, **cycle_kwargs)
    return x


# --------------------------------------------------- automatic path choice
def _infer_grid_shape(A: SparseOperator):
    """(h, w) when A's pattern is a square-grid stencil, else None: the
    vertex count is a square and every edge falls into at most MAX_TAPS
    modular (dy, dx) shift classes."""
    n = A.n_rows
    h = math.isqrt(n)
    if h * h != n:
        return None
    rows, cols, _ = A.host_coo()
    try:
        stencil_classes(rows, cols, h, h)
    except ValueError:
        return None
    return (h, h)


class AutoTwoGrid:
    """Two-grid solver on the fastest layout this operator admits.

    Probe order (each refuses with a ValueError, recorded in `why`):
      stencil  the fine level on kernel K4 (`StencilVCycle`; square-grid
               stencil patterns)
      dia      the plain DIA layout (`setup_with_dia`; banded patterns)
      stream   A on kernel K2 in RCM order (`setup_with_stream`; general
               graphs of at least 4096 rows)
      coo      always works

    `layout` records the choice. `run(b, x)` is one cycle, `solve(b, x,
    n_cycles=...)` several, each a program (`utils/program.py`) as the
    JAX methods are jitted: a captured graph on the card. The JAX
    package's `stream_backend` option has no counterpart: the port has one
    backend. The JAX package's TPU VMEM guard is not kept either, so on
    grids a TPU's VMEM cannot hold the port picks "stencil" where the JAX
    package falls through to "dia"."""

    def __init__(self, setup: TwoGridSetup, *, grid_shape=None,
                 layouts=("stencil", "dia", "stream", "coo"),
                 **cycle_kwargs):
        if not isinstance(setup.A, SparseOperator):
            raise ValueError("pass the plain COO setup (before any "
                             "setup_with_* swap)")
        self.cycle_kwargs = cycle_kwargs
        self.why = {}
        self._stencil = None
        self.setup = setup
        for lay in layouts:
            try:
                if lay == "stencil":
                    gs = grid_shape or _infer_grid_shape(setup.A)
                    if gs is None:
                        raise ValueError("pattern is not a tensor-product "
                                         "grid")
                    self._stencil = StencilVCycle(setup, gs, **cycle_kwargs)
                elif lay == "dia":
                    swapped = setup_with_dia(setup)
                    if isinstance(swapped.A, SparseOperator):
                        raise ValueError("pattern not banded enough for "
                                         "DIA")
                    self.setup = swapped
                elif lay == "stream":
                    if setup.A.n_rows < 4096:
                        raise ValueError(
                            "operator too small for the stream kernel "
                            "(single 1024-row tile dominates; COO wins)")
                    self.setup = setup_with_stream(setup)
                elif lay != "coo":
                    raise ValueError(f"unknown layout {lay!r}")
                self.layout = lay
                break
            except ValueError as e:
                self.why[lay] = str(e)
        else:
            raise ValueError(f"no layout accepted this operator: "
                             f"{self.why}")
        if self._stencil is None:  # the JAX `_run`, and `solve`'s jit
            self._run = program(vcycle)
            self._solve = program(solve)

    def run(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One two-grid cycle on the chosen path, as a program."""
        if self._stencil is not None:
            return self._stencil.run(b, x)
        return self._run(self.setup, b, x, **self.cycle_kwargs)

    def solve(self, b: torch.Tensor, x: torch.Tensor, *,
              n_cycles: int) -> torch.Tensor:
        """n_cycles cycles: on the stencil layout a loop of `run`s (as
        the JAX method loops), else one program of `solve`."""
        if self._stencil is not None:
            x = x.reshape(-1)
            for _ in range(n_cycles):
                x = self._stencil.run(b, x)
            return x
        return self._solve(self.setup, b, x, n_cycles=n_cycles,
                           **self.cycle_kwargs)


def setup_auto(A: SparseOperator, *, theta: float = 0.25,
               splitting: str = "cljp", seed: int = 0,
               diag=None, trunc: float = 0.0,
               interp: str = "reference", grid_shape=None,
               **cycle_kwargs) -> AutoTwoGrid:
    """setup_twogrid + automatic layout choice in one call.

    Returns an AutoTwoGrid whose `.layout` says which path won (stencil >
    dia > stream > coo; pass `layouts=` to restrict the probes). Cycle
    parameters (n_pre, n_post, omega, coarse_*) go in **cycle_kwargs; the
    numerics match `vcycle` on the plain setup on every path."""
    setup = setup_twogrid(A, theta=theta, splitting=splitting, seed=seed,
                          diag=diag, trunc=trunc, interp=interp)
    return AutoTwoGrid(setup, grid_shape=grid_shape, **cycle_kwargs)
