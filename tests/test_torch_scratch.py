"""The scratch twins (gnnla_tpu_torch/scratch/ and the kernels K6-K9)
against the JAX repository's scratch/ scripts on the CPU.

The scripts are loaded by file path. Their Pallas kernels run in interpret
mode (pl.pallas_call patched, as tests/test_torch_ops.py does); where a
script keeps its kernel's output to itself, its module's `jax.jit` is made
the identity, so the call runs eagerly and its output can be recorded. The
port runs its kernels' plain versions, which its wrappers take for CPU
tensors. Tolerances are stated per test.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnnla_tpu.ops.pallas_stream import StreamSpMV
from gnnla_tpu_torch.ops import ellw_spmv as E
from gnnla_tpu_torch.ops.gather_probe import (GatherProbe, axis0_plain,
                                              axis1_plain)
from gnnla_tpu_torch.ops.stream_ablate import (STAGES, VARIANTS,
                                               StreamAblation)
from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV
from gnnla_tpu_torch.scratch import (ablate_stream, bench_stream,
                                     probe_dyngather, probe_stream,
                                     proto_ellw)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def load_script(name):
    """scratch/<name>.py as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"scratch_{name}", os.path.join(ROOT, "scratch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret_mode(monkeypatch):
    """pl.pallas_call in interpret mode; every call's outputs recorded."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    outputs = []

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        call = real(*args, **kwargs)

        def recorded(*a):
            out = call(*a)
            outputs.append(out)
            return out
        return recorded

    monkeypatch.setattr(pl, "pallas_call", patched)
    return outputs


def eager(monkeypatch, mod):
    """Make `mod`'s jax.jit the identity, so its kernels run eagerly."""
    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                     if not k.startswith("__")})
    proxy.jit = lambda f, **kw: f
    monkeypatch.setattr(mod, "jax", proxy)


def delaunay(n, seed=7):
    return proto_ellw.rcm_ordered(proto_ellw.delaunay_laplacian(
        n, np.random.default_rng(seed)))


def assert_same_layout(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = want[k], got[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert type(a) is type(b) and a == b, k


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("n", [3000, 2500, 1024, 700])
def test_build_ellw_is_the_scripts(n):
    """Every array and scalar bitwise proto_ellw.py's build_ellw, full and
    partial last tiles (and a single tile)."""
    lap = delaunay(n)
    assert_same_layout(load_script("proto_ellw").build_ellw(lap),
                       E.build_ellw(lap))


def test_build_ellw_on_the_knn_fixture():
    A = bench_stream.fixture(1500)
    assert_same_layout(load_script("proto_ellw").build_ellw(A),
                       E.build_ellw(A))


def test_from_slots_is_the_scripts_packing_of_the_slots():
    """from_slots packs the slot list as build_ellw packs a CSR holding
    the same entries in the same order (duplicates and unsorted columns
    kept): bitwise."""
    cols, vals, A, x = probe_stream.fixture()
    n, k = cols.shape
    slot_csr = types.SimpleNamespace(
        indptr=np.arange(0, n * k + 1, k), indices=cols.reshape(-1),
        data=vals.reshape(-1), shape=(n, n))
    assert_same_layout(load_script("proto_ellw").build_ellw(slot_csr),
                       E.from_slots(cols, vals))


def test_ellw_plain_matches_the_interpreted_kernel(interpret_mode):
    """The plain version against make_call(interpret=True) on the
    3,000-point Delaunay Laplacian: within 1e-5 * max|y| (XLA on the CPU
    may contract the multiply-adds)."""
    pe = load_script("proto_ellw")
    lap = delaunay(3000)
    meta = pe.build_ellw(lap)
    x = np.random.default_rng(1).standard_normal(3000).astype(np.float32)
    x_pad = np.zeros(meta["L"] + meta["W"], np.float32)
    x_pad[:3000] = x
    call = pe.make_call(meta, interpret=True)
    want = np.asarray(call(*(jnp.asarray(meta[k]) for k in (
        "start", "bounds", "idx", "val")), jnp.asarray(x_pad))).reshape(
        -1)[:3000]
    op = E.EllwSpMV(E.build_ellw(lap), device=CPU)
    got = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert op.launches == 0
    # and the plain version is the slot-order sum: exactly scipy's here
    np.testing.assert_allclose(got, lap @ x, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_ellw_window_path_and_refusals():
    """The window path follows W (shared up to ELLW_SMEM_BYTES); the
    wrapper refuses a wrong x, the raw launch a CPU tensor, the layout a
    column outside its window."""
    meta = E.build_ellw(delaunay(3000))
    gen = np.random.default_rng(3)
    rows = np.arange(40_000)[:, None]
    wide = E.from_slots(np.clip(rows + gen.integers(-15_000, 15_001,
                                                    (40_000, 6)), 0, 39_999),
                        gen.standard_normal((40_000, 6)).astype(np.float32))
    assert meta["W"] * 4 <= E.ELLW_SMEM_BYTES < wide["W"] * 4
    assert E.EllwSpMV(meta, device=CPU).path == "shared"
    assert E.EllwSpMV(wide, device=CPU).path == "read-only cache"
    op = E.EllwSpMV(meta, device=CPU)
    assert op.padding_waste == pytest.approx(
        meta["n_tiles"] * 1024 * meta["K"] / meta["nnz"])
    with pytest.raises(ValueError, match="expects"):
        op.matvec(torch.zeros(5))
    with pytest.raises(ValueError, match="not CUDA"):
        E.ellw_cuda(op.idx, op.val, op.start, torch.zeros(3000), op.W, True)
    bad = dict(meta, idx=meta["idx"].copy())
    bad["idx"][0, 0, 0] = meta["W"]
    with pytest.raises(ValueError, match="outside its window"):
        E.EllwSpMV(bad, device=CPU)
    with pytest.raises(ValueError, match=r"\[n, K >= 1\]"):
        E.from_slots(np.zeros(4, int), np.zeros(4, np.float32))


# ------------------------------------------------------------- K7, K8
@pytest.mark.parametrize("n_chunks", [2, 3])
def test_axis1_plain_is_the_interpreted_probe(monkeypatch, interpret_mode,
                                              n_chunks):
    """K7's plain version bitwise the interpreted probe_axis1 kernel."""
    pd = load_script("probe_dyngather")
    eager(monkeypatch, pd)
    pd.probe_axis1(R=8, n_chunks=n_chunks, n_blocks=2, n_iters=1)
    want = np.asarray(interpret_mode[0])
    win, lo, hi, vals, idx = probe_dyngather.axis1_inputs(8, n_chunks, 2)
    got = axis1_plain(*(torch.from_numpy(a) for a in (win, lo, hi, vals)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,n_blocks", [(8, 4), (16, 2)])
def test_axis0_plain_is_the_interpreted_probe(monkeypatch, interpret_mode,
                                              R, n_blocks):
    """K8's plain version bitwise the interpreted probe_axis0 kernel."""
    pd = load_script("probe_dyngather")
    eager(monkeypatch, pd)
    pd.probe_axis0(R=R, n_blocks=n_blocks, n_iters=1)
    want = np.asarray(interpret_mode[0])
    win, idx = probe_dyngather.axis0_inputs(R, n_blocks)
    got = axis0_plain(torch.from_numpy(win), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_probe_counts_only_card_launches():
    probe = GatherProbe()
    win, idx = probe_dyngather.axis0_inputs(8, 2)
    probe.axis0(torch.from_numpy(win), torch.from_numpy(idx))
    assert probe.launches == {"axis1": 0, "axis0": 0}


# -------------------------------------------------------- stream probe
def test_stream_probe_matches_the_interpreted_kernel(monkeypatch,
                                                     interpret_mode):
    """probe_stream.py's main in interpret mode (its kernel2 on the TPU
    pack) against the twin's K6 (from_slots) and K2 plain versions on the
    same fixture: within 1e-6 * max|y|."""
    ps = load_script("probe_stream")
    eager(monkeypatch, ps)
    ps.main()
    want = np.asarray(interpret_mode[-1]).reshape(-1)
    out = probe_stream.run(CPU, iters=1, verbose=False)
    for key in ("K6", "K2"):
        np.testing.assert_allclose(out[key]["y"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert out["K"] == 5


# --------------------------------------------------------- k-NN fixture
@pytest.mark.parametrize("n", [300, 1200])
def test_knn_laplacian_is_the_scripts(n):
    want = load_script("bench_stream").knn_laplacian(n)
    got = bench_stream.knn_laplacian(n)
    assert got.dtype == want.dtype == np.float32
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr))


# ------------------------------------------------------------------ K9
@pytest.fixture(scope="module")
def ablation_op():
    A = ablate_stream.fixture(proto_ellw.delaunay_laplacian(
        3000, np.random.default_rng(7)))
    return A, CsrSpMV(A, device=CPU)


def test_full_variant_matches_jax_stream_spmv(ablation_op):
    """`full` (K2's function) against the JAX stream SpMV on its numpy
    emulator, the kernel the script ablates: within 1e-6 * max|y|."""
    A, k2 = ablation_op
    x = np.random.default_rng(2).standard_normal(A.shape[0]).astype(
        np.float32)
    want = np.asarray(StreamSpMV(A.astype(np.float32), backend="emulate")
                      .matvec(jnp.asarray(x)))
    got = StreamAblation(k2)("full", torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _numpy_variant(variant, A, rb, x):
    """The variants' definitions written out in numpy, row by row."""
    gather, deposit, scan = STAGES[variant]
    rp, cols, vals = A.indptr, A.indices, A.data.astype(np.float32)
    terms = vals * x[cols] if gather else vals + x[0]
    y = np.zeros(A.shape[0], np.float32)
    if scan:
        for r in range(A.shape[0]):
            for p in range(rp[r], rp[r + 1]):
                y[r] = np.float32(y[r] + terms[p])
    elif deposit:
        for r in range(A.shape[0]):
            if rp[r + 1] > rp[r]:
                y[r] = terms[rp[r]]
    else:
        for b in range(len(rb) - 1):
            r0, r1 = rb[b], rb[b + 1]
            p0, p1 = rp[r0], rp[r1]
            for t in range(min(256, r1 - r0)):
                acc = np.float32(0)
                g = (p0 >> 2) + t
                while 4 * g < p1:
                    for p in range(4 * g, 4 * g + 4):
                        if p0 <= p < p1:
                            acc = np.float32(acc + terms[p])
                    g += 256
                y[r0 + t] = acc
    return y


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_plain_versions(ablation_op, variant):
    """Each variant's plain version bitwise its numpy definition."""
    A, k2 = ablation_op
    x = np.random.default_rng(3).standard_normal(A.shape[0]).astype(
        np.float32)
    got = StreamAblation(k2)(variant, torch.from_numpy(x)).numpy()
    want = _numpy_variant(variant, A, k2.row_blocks.numpy(), x)
    np.testing.assert_array_equal(got, want)


def test_ablation_refuses_long_rows_and_unknown_variants():
    n = 300
    A = sp.random(n, n, density=0.5, random_state=1, format="csr",
                  dtype=np.float32)
    with pytest.raises(ValueError, match="longer than"):
        StreamAblation(CsrSpMV(A, device=CPU))
    ab = StreamAblation(CsrSpMV(sp.eye(n, format="csr", dtype=np.float32),
                                device=CPU))
    with pytest.raises(ValueError, match="none of"):
        ab("fast", torch.zeros(n))
    assert ab.launches == dict.fromkeys(VARIANTS, 0)


# ------------------------------------------------------------- the mains
@pytest.mark.parametrize("module,argv,lines", [
    ("proto_ellw", ["--n", "2000"], ("setup", "rel err", "edges/s")),
    ("probe_dyngather", ["--scale", "64"], ("max err", "gathers/s",
                                            "edges/s")),
    ("probe_stream", [], ("rel err", "OK")),
    ("ablate_stream", ["--n", "2000", "full", "noscan"],
     ("fixture", "full", "noscan", "costs")),
    ("bench_stream", ["3000"], ("fixture", "rel err", "edges/s",
                                "vjp rel err", "cpu scipy")),
    ("probe_gather", ["--n", "20000"], ("K-gathers", "2D gather",
                                        "segsum", "torch.take"))])
def test_main_on_the_cpu(capsys, module, argv, lines):
    """Each twin's main with --cpu at a tiny size prints its script's
    lines (on stderr, where the scripts print) and passes its checks."""
    mod = importlib.import_module(f"gnnla_tpu_torch.scratch.{module}")
    assert mod.main(argv + ["--cpu"]) is not None
    err = capsys.readouterr().err
    for word in lines:
        assert word in err, (word, err)
    assert "host CPU" in err


def test_mains_refuse_the_card_without_one(monkeypatch):
    """Without --cpu a twin asks for the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_stream.main([])
