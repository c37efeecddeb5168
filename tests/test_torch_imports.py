"""The PyTorch port stands alone: no jax, flax or gnnla_tpu imports in
gnnla_tpu_torch or chip_smoke.py (nor of the JAX repository's scratch/
scripts or its root bench.py), and no quiet CPU fallback."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gnnla_tpu",
             "scratch", "bench")
EXAMPLES = ("matvec", "residual_norm", "jacobi", "chebyshev", "power_method",
            "soc_interp", "vcycle", "multigrid_pcg", "train_jacobi",
            "train_diffusion", "band_layout", "unstructured_ell",
            "distributed")
PARALLEL = ("partition", "collectives", "distributed", "spmv", "stencil",
            "stream", "vcycle", "krylov", "hardware_check", "dryrun")
SCRATCH = ("proto_ellw", "probe_dyngather", "probe_stream", "ablate_stream",
           "bench_stream", "probe_gather")
KERNEL_OPS = ("ellw_spmv", "gather_probe", "stream_ablate")
SCRIPTS = ("_common", "reproduce_jacobi", "reproduce_jacobi_stable",
           "smoother_twogrid", "reproduce_diffusion", "grid_diffusion",
           "gen_results")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "gnnla_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    files = [os.path.relpath(p, ROOT) for p in _port_files()]
    for must in ("chip_smoke.py", "gnnla_tpu_torch/bench.py",
                 "gnnla_tpu_torch/models/vcycle.py",
                 "gnnla_tpu_torch/models/geometric.py",
                 "gnnla_tpu_torch/ops/dia_spmv.py",
                 "gnnla_tpu_torch/ops/stream_spmv.py",
                 "gnnla_tpu_torch/ops/stencil.py",
                 "gnnla_tpu_torch/ops/stencil_kernel.py",
                 "gnnla_tpu_torch/ops/band.py",
                 "gnnla_tpu_torch/core/block.py",
                 "gnnla_tpu_torch/models/trainable_jacobi.py",
                 "gnnla_tpu_torch/training/train_jacobi.py",
                 "gnnla_tpu_torch/training/spectral_loss.py",
                 "gnnla_tpu_torch/amg/aggregation.py",
                 "gnnla_tpu_torch/models/multigrid.py",
                 "gnnla_tpu_torch/models/krylov.py",
                 "gnnla_tpu_torch/problems/fem_heateqn.py",
                 "gnnla_tpu_torch/core/graph.py",
                 "gnnla_tpu_torch/core/convert.py",
                 "gnnla_tpu_torch/core/batch.py",
                 "gnnla_tpu_torch/core/__init__.py",
                 "gnnla_tpu_torch/problems/laplacian.py",
                 "gnnla_tpu_torch/models/matvec.py",
                 "gnnla_tpu_torch/models/residual.py",
                 "gnnla_tpu_torch/models/norm.py",
                 "gnnla_tpu_torch/models/jacobi.py",
                 "gnnla_tpu_torch/models/chebyshev.py",
                 "gnnla_tpu_torch/models/power_method.py",
                 "gnnla_tpu_torch/models/soc.py",
                 "gnnla_tpu_torch/models/direct_interp.py",
                 "gnnla_tpu_torch/problems/diffusion_fem.py",
                 "gnnla_tpu_torch/models/diffusion_gnn.py",
                 "gnnla_tpu_torch/training/train_diffusion.py",
                 "gnnla_tpu_torch/evaluation/__init__.py",
                 "gnnla_tpu_torch/evaluation/eigen_analysis.py",
                 "gnnla_tpu_torch/evaluation/ood.py",
                 "gnnla_tpu_torch/evaluation/freq_study.py",
                 "gnnla_tpu_torch/evaluation/viz.py",
                 "gnnla_tpu_torch/cli.py",
                 "gnnla_tpu_torch/utils/__init__.py",
                 "gnnla_tpu_torch/utils/metrics.py",
                 "gnnla_tpu_torch/utils/health.py",
                 "gnnla_tpu_torch/ops/bsr.py",
                 "gnnla_tpu_torch/examples/run_all.py",
                 "gnnla_tpu_torch/training/data_parallel.py",
                 "gnnla_tpu_torch/parallel/__init__.py",
                 *(f"gnnla_tpu_torch/parallel/{name}.py"
                   for name in PARALLEL),
                 "gnnla_tpu_torch/scratch/__init__.py",
                 *(f"gnnla_tpu_torch/scratch/{name}.py"
                   for name in SCRATCH),
                 *(f"gnnla_tpu_torch/ops/{name}.py" for name in KERNEL_OPS),
                 "gnnla_tpu_torch/scripts/__init__.py",
                 *(f"gnnla_tpu_torch/scripts/{name}.py" for name in SCRIPTS),
                 *(f"gnnla_tpu_torch/examples/{name}.py"
                   for name in EXAMPLES)):
        assert must in files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_gnnla_tpu_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, gnnla_tpu_torch.models, gnnla_tpu_torch.bench, "
            "gnnla_tpu_torch.ops.dia_spmv, gnnla_tpu_torch.ops.stream_op, "
            "gnnla_tpu_torch.ops.stencil_kernel, gnnla_tpu_torch.native_ext, "
            "gnnla_tpu_torch.training, gnnla_tpu_torch.amg.aggregation, "
            "gnnla_tpu_torch.models.multigrid, gnnla_tpu_torch.models.krylov, "
            "gnnla_tpu_torch.problems.fem_heateqn, "
            "gnnla_tpu_torch.training.checkpoints, gnnla_tpu_torch.core, "
            "gnnla_tpu_torch.problems.diffusion_fem, "
            "gnnla_tpu_torch.models.diffusion_gnn, "
            "gnnla_tpu_torch.training.train_diffusion, "
            "gnnla_tpu_torch.evaluation, gnnla_tpu_torch.evaluation.viz, "
            "gnnla_tpu_torch.cli, gnnla_tpu_torch.utils, "
            "gnnla_tpu_torch.utils.metrics, gnnla_tpu_torch.utils.health, "
            "gnnla_tpu_torch.ops.bsr, gnnla_tpu_torch.examples.run_all, "
            "gnnla_tpu_torch.parallel, "
            "gnnla_tpu_torch.training.data_parallel, "
            + ", ".join(f"gnnla_tpu_torch.parallel.{name}"
                        for name in PARALLEL) + ", "
            + ", ".join(f"gnnla_tpu_torch.examples.{name}"
                        for name in EXAMPLES) + ", "
            + ", ".join(f"gnnla_tpu_torch.scratch.{name}"
                        for name in SCRATCH) + ", "
            + ", ".join(f"gnnla_tpu_torch.ops.{name}"
                        for name in KERNEL_OPS) + ", "
            + ", ".join(f"gnnla_tpu_torch.scripts.{name}"
                        for name in SCRIPTS) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    from gnnla_tpu_torch.models.vcycle import setup_from_numpy
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.problems import laplacian_2d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        laplacian_2d(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseOperator.from_coo([0], [0], [1.0], (1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_from_numpy({})
    from gnnla_tpu_torch.models.trainable_jacobi import TrainableJacobiMLP
    from gnnla_tpu_torch.problems import small_band_matrix
    from gnnla_tpu_torch.training import (TrainJacobiConfig,
                                          small_band_dataset, train_jacobi)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainableJacobiMLP()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small_band_matrix(6, 0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small_band_dataset(2, n=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_jacobi(TrainJacobiConfig(num_matrices=2, n_mesh=6,
                                       cache_dir=None))
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
    from gnnla_tpu_torch.ops.band import BandLayout, BandPattern
    from gnnla_tpu_torch.problems import cosine_diffusion_matrix
    from gnnla_tpu_torch.training import (TrainDiffusionConfig,
                                          cosine_diffusion_dataset,
                                          frequency_study_dataset,
                                          train_diffusion)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionGNN(1, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cosine_diffusion_matrix((1.0, 1.0, 1.0, 1.0), 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cosine_diffusion_dataset(2, n=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frequency_study_dataset(n=4, max_freq=0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_diffusion(TrainDiffusionConfig(num_matrices=2, n_mesh=4,
                                             cache_dir=None))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BandPattern.from_layout(BandLayout(laplacian_2d(3, device="cpu")))
    from gnnla_tpu_torch.cli import main as cli_main
    from gnnla_tpu_torch.examples import matvec as matvec_example
    from gnnla_tpu_torch.ops.bsr import to_bsr
    from gnnla_tpu_torch.utils import Timer, health_probe, profile_trace
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["diffusion", "--num-matrices", "20", "--n-mesh", "4",
                  "--epochs", "1", "--end-index", "1", "--cache-dir", ""])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        matvec_example.main(n=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_bsr(laplacian_2d(4, device="cpu"), block_size=4, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Timer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profile_trace("unused"):
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        health_probe()
    from gnnla_tpu_torch.examples import distributed as dist_example
    from gnnla_tpu_torch.parallel import initialize_distributed
    from gnnla_tpu_torch.parallel.hardware_check import \
        run_sharded_hardware_check
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed("file:///nonexistent/store", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sharded_hardware_check()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist_example.main()
    from gnnla_tpu_torch.scripts import (grid_diffusion, reproduce_diffusion,
                                         reproduce_jacobi,
                                         reproduce_jacobi_stable,
                                         smoother_twogrid)
    for twin in (reproduce_jacobi, reproduce_jacobi_stable, smoother_twogrid,
                 reproduce_diffusion, grid_diffusion):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            twin.main()
    # asked for explicitly, the CPU runs the plain versions
    assert laplacian_2d(4, device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    """The raw launchers never run the plain version: only the operator
    wrappers pick it, and only for CPU tensors."""
    from gnnla_tpu_torch.ops.dia_spmv import dia_tiles, dia_tiles_spmv_cuda
    from gnnla_tpu_torch.ops.stencil_kernel import stencil_cuda
    from gnnla_tpu_torch.ops.stream_spmv import csr_spmv_cuda
    from gnnla_tpu_torch.utils.health import health_cuda

    x = torch.zeros(4)
    with pytest.raises(ValueError, match="not CUDA"):
        health_cuda(torch.ones(8, 128))
    with pytest.raises(ValueError, match="not CUDA"):
        dia_tiles_spmv_cuda(dia_tiles(torch.ones(1, 4), (0,)), x)
    with pytest.raises(ValueError, match="not CUDA"):
        csr_spmv_cuda(torch.zeros(5, dtype=torch.int32),
                      torch.zeros(0, dtype=torch.int32), torch.zeros(0), x, 4)
    with pytest.raises(ValueError, match="not CUDA"):
        csr_spmv_cuda(torch.zeros(5, dtype=torch.int32),
                      torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                      torch.zeros(4, 2), 4)
    with pytest.raises(ValueError, match="not CUDA"):
        stencil_cuda(torch.zeros(1, 2, 2), torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, 2), 1, "plain")
    from gnnla_tpu_torch.ops.ellw_spmv import ellw_cuda
    from gnnla_tpu_torch.ops.gather_probe import axis0_cuda, axis1_cuda
    from gnnla_tpu_torch.ops.stream_ablate import StreamAblation
    from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV
    import scipy.sparse as sp
    i32 = torch.int32
    with pytest.raises(ValueError, match="not CUDA"):
        ellw_cuda(torch.zeros(1, 8, 128, dtype=i32), torch.zeros(1, 8, 128),
                  torch.zeros(1, dtype=i32), x, 128, True)
    with pytest.raises(ValueError, match="not CUDA"):
        axis1_cuda(torch.zeros(128), torch.zeros(1, 128, dtype=i32),
                   torch.zeros(1, 128, dtype=i32), torch.zeros(1, 128))
    with pytest.raises(ValueError, match="not CUDA"):
        axis0_cuda(torch.zeros(8, 128), torch.zeros(1, 128, dtype=i32))
    ablation = StreamAblation(CsrSpMV(sp.eye(4, format="csr",
                                             dtype="float32"), device="cpu"))
    with pytest.raises(ValueError, match="not on"):
        ablation.raw("full", x)


def test_build_is_lazy():
    """Importing every port module (and chip_smoke) builds and loads no
    kernel, so the CPU needs no nvcc."""
    code = ("import chip_smoke, gnnla_tpu_torch.models, "
            "gnnla_tpu_torch.bench, "
            "gnnla_tpu_torch.ops.dia_spmv, gnnla_tpu_torch.ops.stream_op, "
            "gnnla_tpu_torch.ops.stencil_kernel, "
            "gnnla_tpu_torch.training, gnnla_tpu_torch.utils, "
            "gnnla_tpu_torch.ops.bsr, gnnla_tpu_torch.cli, "
            "gnnla_tpu_torch.examples.run_all, "
            + ", ".join(f"gnnla_tpu_torch.scratch.{name}"
                        for name in SCRATCH) + ", "
            + ", ".join(f"gnnla_tpu_torch.ops.{name}"
                        for name in KERNEL_OPS) + ", "
            + ", ".join(f"gnnla_tpu_torch.scripts.{name}"
                        for name in SCRIPTS) + "; "
            "from gnnla_tpu_torch import _build; "
            "raise SystemExit(0 if _build._lib is None else 1)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_package_data_ships_every_kernel_source():
    """A non-editable install carries every file the kernels build from:
    each of `_build.SOURCES` and `_build.HEADERS` (which the build hashes)
    and each csrc/*.cu(h) on disk matches a package-data glob."""
    import fnmatch
    import tomllib

    from gnnla_tpu_torch import _build

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "gnnla_tpu_torch"]
    csrc = os.path.join(ROOT, "gnnla_tpu_torch", "csrc")
    names = set(_build.SOURCES) | set(_build.HEADERS) | {
        f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh"))}
    assert _build.HEADERS
    for name in sorted(names):
        assert os.path.exists(os.path.join(csrc, name)), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name
