"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. device  — requires CUDA; the card's name, count, CUDA version, and
               nvidia-smi's `name, power.limit` line.
  2. build   — builds the kernels from gnnla_tpu_torch/csrc (nvcc, sm_90a)
               and prints the build seconds and ptxas register, shared
               memory and spill lines; then kernel K5, the health probe
               (`utils/health.py::health_probe`, y = 2 x on one 8 x 128
               block): y == 2 bitwise, one launch; K5 bitwise its plain
               version on random x; its raw launch, its wrapper and
               `torch.mul(x, 2)` timed in turns, flushed, beside each
               kernel's profiler device time and the bound.
  3. setup   — the 1024^2 FD Laplacian, `setup_twogrid(theta=0.25, cljp,
               seed=0)`, `setup_with_dia(kernel=True)`, `setup_with_stream_p`;
               asserts A and Ac are on kernel K1 and P on kernel K2, and
               that Ac's compact K1 layout holds at most 378,269 segments
               (32-row tile, diagonal) in under 80 MB.
  4. kernels — each kernel's wrapper against its plain PyTorch version on
               the card, at the main path's shapes (rtol 1e-5, atol
               1e-5 * max|y|: the two sum in different orders in f32);
               K2 on P and P^T bitwise the CSR-order mul-then-add
               (`csr_sequential`).
  5. solve   — 5 cycles of `solve`; the residual must fall every cycle;
               the launch counts must be exactly 11 K1 and 2 K2 launches
               per cycle, and no K1 layout rebuilt; x must match the plain
               path on the card (max error <= 1e-4 relative to max|x|); a
               64^2 run must match the port's CPU path.
  6. times   — ms/cycle (CUDA events over 20 warm cycles); per kernel and
               shape the kernel, plain version and cuSPARSE (`library_ms`)
               times with the L2 cache flushed before each call, beside
               the memory-rate bound (K1: of its compact layout, beside
               the bound of a walk over all K diagonals and the nonzeros'
               floor);
               whether K1 on Ac beats cuSPARSE; the wrapper's and the raw
               launch's back-to-back, L2-warm times; peak device memory; a
               profiler breakdown of one cycle's device time and idle
               share.
The grid path (kernel K4, the fused stencil) on the same 1024^2 operator:
  7. grid_setup   — the alternating setup, `GeometricVCycle(setup=...)` and
                    `AutoTwoGrid` on the CLJP setup of phase 3 (host
                    seconds); asserts the auto layout is "stencil" with
                    Ac on K1 (`DiaKernelOperator`) and P on K2
                    (`RectStreamOperator`).
  8. grid_kernels — K4 against its plain version on the card at the grid
                    path's shapes: plain on the 1024 x 512 Ac (one step),
                    affine Jacobi (3 steps) and residual (1 step) on 1024^2,
                    normalize (10 steps), bf16-tap Jacobi, and plain on the
                    transposed taps (3 steps). rtol 1e-5, atol 1e-5 *
                    max|y|; normalize n_steps * 64 * 2^-24 (see
                    NORM_ULPS_PER_STEP). Each call's form, tile and halo:
                    the 3-step plain and affine calls in the tile form, the
                    others per step, all but normalize bitwise the plain
                    version; the tile form (forced on one-step calls)
                    bitwise too in plain and affine at 1 and 3 steps, f32
                    and bf16, and an operator with a reach of 40 at 3 steps
                    in the per-step form.
  9. grid         — 5 `GeometricVCycle` cycles: the residual falls every
                    cycle; exactly 7 K4 launches per cycle (1 + 1 + 4 + 1);
                    x matches the generic cycle on the same alternating
                    setup on the plain COO path (1e-4 of max|x|); a 64^2
                    run matches the port's CPU path.
 10. auto         — 5 `AutoTwoGrid` (stencil) cycles: the residual falls
                    every cycle; exactly 3 K4 launches per cycle, 4 K1
                    launches on Ac and one K2 launch each for P^T and P;
                    x matches phase 5's plain cycle (1e-4 of max|x|) and,
                    within K1's tolerance (RTOL), the same stencil cycle
                    with the plain DIA Ac and the COO P.
 11. grid_times   — ms/cycle of both (CUDA events over 20 warm cycles;
                    `run` replays a program, as in phases 9, 10 and 12); per
                    K4 shape the flushed and L2-warm times, plain time,
                    bound, launches per cycle and, for the two one-step
                    shapes, one cuSPARSE call (`mat @ x`, `torch.addmv`
                    for the residual c - A x) checked against the kernel;
                    a profiler breakdown of one geometric cycle.
The stream leg of `AutoTwoGrid` (kernel K2 on a square RCM-ordered A):
 12. stream       — the 1024^2 Laplacian with its vertices shuffled; its
                    CLJP setup; `AutoTwoGrid` picks "stream". K2 on the
                    RCM-ordered CSR and its transpose against their plain
                    versions, matvec/rmatvec in caller order against the
                    plain COO operator (rtol 1e-5); 5 cycles: the residual
                    falls every cycle, exactly 7 K2 launches per cycle, x
                    matches the plain cycle (1e-4 of max|x|); ms/cycle,
                    the K2 row's times and a profile of one cycle. K2 on
                    A_rcm and A_rcm^T bitwise the CSR-order sum; on a
                    power-law CSR (rows of 1 to 10,000 nonzeros: over
                    256 summed by whole blocks, 65 to 256 by warps)
                    against its plain version, bitwise on its rows of at
                    most 256, and flushed ms.
                    K2's backward: a scalar of matvec and of rmatvec
                    differentiated on the card (one K2 launch forward,
                    one on the other CSR backward) against the plain COO
                    operator's x-gradient, and the values gradient against
                    the plain CSR version's; a `csr_spmv[A_rcm_T,
                    backward]` row.
Training the learned Jacobi smoother (kernel K3, the multi-RHS SpMM):
 13. spmm         — K3 on the stream phase's RCM-ordered CSR and on its
                    transpose at M = 20 (the trainer's probe count)
                    against the plain version (rtol 1e-5) and bitwise
                    against a CSR-order sequential sum in PyTorch; the
                    scalar variant at M = 7 and on a misaligned X, the
                    same checks; flushed, warm and profiler device times;
                    the bytes bound; on each, one `torch.sparse.mm`
                    (cuSPARSE) checked against it.
 14. train_stream — that operator negated: the Gelfand loss on K3 against
                    the plain COO path (loss rtol 1e-4, gradient in the
                    diagonal rtol 1e-3 + 1e-5 max|g|), exactly 3 K3
                    launches on A and 2 on A^T per value-and-grad, four
                    descent steps lower the loss; then the learned-D step
                    (features -> MLP with the committed weights -> loss ->
                    backward -> Adam): MLP gradients against the plain
                    path (rtol 1e-3), ms per step, idle share.
 15. jacobi_weights — artifacts/jacobi/params.npz on the card: the 150
                    regenerated test matrices give the artifact's diag_A
                    (rtol 1e-6); the learned (2/3)/D equals the CPU's
                    (rtol 1e-5) and the artifact's diag_learn_Dinv (max
                    relative error <= 3e-2, mean < 1e-2).
 16. train        — `train` at the reference's widths on 300 matrices,
                    2 epochs, in the "dia" and "stencil" layouts: finite
                    losses and gradients, the first step's loss equal to
                    the CPU's and across layouts (rtol 1e-4), ms per step
                    and idle share.
The last kernel contracts (K1's backward and bf16 storage, K4's backward):
 17. dia_grad     — K1's autograd Function on A (K = 5) and the fast Ac
                    (K = 415): the gradients of <w, A x> in x and in the
                    diagonals against the plain DIA matvec's autograd (rtol
                    1e-5 + 1e-5 max|g|); exactly 1 + 1 K1 launches per
                    forward and backward; `dia_spmv[At]`, `dia_spmv[Act]`
                    rows (the backward's launch, cuSPARSE on the CSR of
                    A^T as the yardstick).
 18. dia_bf16     — K1 on bf16 diagonals: on A bitwise equal to the f32
                    kernel, on Ac against the plain bf16-stored version;
                    `dia_spmv_bf16[A]`, `dia_spmv_bf16[Ac]` rows (2-byte
                    diagonals in the bound).
 19. stencil_grad — `StencilSpMV` at 1 and 3 steps on 1024^2: the x and taps
                    gradients against the plain roll twin's autograd;
                    exactly 1 K4 launch each way (per step at one step, the
                    tile form at 3); a `stencil[plain,T]` row.
The multilevel hierarchies and the Krylov solvers:
 20. multigrid    — `setup_sa_multigrid(A, seed=0)`, `setup_with_dia_multigrid(
                    kernel=True)`: levels, rows, nnz, K, which levels are on
                    K1, setup seconds, diagonal bytes; `mg_pcg(n_iters=30,
                    flip_sign=True)` on the main right-hand side reaches
                    1e-8 ||b|| in 15 +- 1 iterations (the JAX package's
                    bench took 15), exact K1 launches per level and K2
                    launches on each P (1 + 1 a cycle), x within
                    1e-4 of max|x| of the same hierarchy on plain DIA
                    levels, a 64^2 run within 2e-5 of the port's CPU path;
                    ms per iteration (median of 5 runs), idle share, peak
                    memory, no K1 layout rebuilt; per K1 level the kernel
                    against its plain version, its flushed, plain and
                    cuSPARSE times (a `dia_spmv[SA<level>]` row each); the
                    classical `setup_multigrid` (pmis) cycles lower the
                    residual.
 20b. dia_nonfinite — K1 on x with +inf, -inf and NaN at columns some rows
                    reach only through a skipped segment (asserted to exist
                    but on the Laplacian's layouts, whose skipped segments
                    all lie past the grid): A, Ac, the first split-form SA
                    level, bf16 Ac, A^T and Ac^T; NaN and inf positions
                    equal the plain version's, finite entries within rtol,
                    no layout rebuilt, the layout's state left zeroed.
 21. pcg          — `amg_pcg(n_iters=10, flip_sign=True)` on the fast
                    setup: below plain `cg` at 10 iterations, exact K1/K2
                    launches, x within 1e-4 of the plain setup's; ms per
                    iteration, idle share.
 22. convergence  — per-cycle convergence factors at 64^2, 128^2, 256^2 of
                    the classical two-grid cycle (fast setup, 8 cycles) and
                    the SA V-cycle (K1 levels, n_pre = n_post = 2, 8
                    cycles): SA below classical, each within 0.01 of the
                    JAX package's table (BENCH_r05.json).
 22b. sa_k2      — the benchmark's solve hierarchies (SA, theta 0.08, seed
                    0, of the 128^3 and 2048^2 FD Laplacians) through
                    `setup_with_dia_multigrid(kernel=True)`: no COO operator
                    left, exact K2 launches in one V(1,1) cycle (3 on a
                    level `to_dia` refused, 8 at such a coarsest, 1 + 1 on
                    each P); 3-D A1, A2, A3, P0, P0^T, P1^T, P2^T and 2-D
                    P0, P0^T: K2 bitwise the CSR-order sum, against its
                    plain version and cuSPARSE, flushed, plain,
                    COO-operator and cuSPARSE times beside the bound, the
                    share of rows and nonzeros in rows of more than 64,
                    the row blocks with warp blocks and before them, and
                    the warp blocks' rows (a `csr_spmv[SA<grid>.<key>]` row
                    each). In that cycle
                    each K1 level that smooths makes 3 fused launches (its
                    two Jacobi sweeps and its residual), the coarsest none;
                    on each such level of both hierarchies, K1's Jacobi and
                    residual forms bitwise the eager chain (every split and
                    repair instantiation the solves launch); on 2-D levels
                    0 and 1 each form flushed, beside K1 with the chain's
                    elementwise kernels (five for a sweep, one for the
                    residual), K1 alone and the fused bytes' bound (a
                    `dia_tiles_<form>[SA2d.A<l>]` row each). The K1
                    coarsest's degree-8 Chebyshev in K1's one-launch form
                    (one launch) bitwise the eager chain (8 K1 launches),
                    with ms and device-busy ms a call of each.
The GN-block engine and the paper's GN forms, held against the kernels:
 23. gn_setup     — `setup_twogrid(use_device_gnn=True)` on phase 3's
                    operator (SOC and direct interpolation as GN blocks on
                    the card, CLJP on the host): phase 3's coarse flags
                    exactly, P within rtol 1e-5 / atol 1e-6 and Ac within
                    rtol 1e-4 / atol 1e-5 of the host setup's; 5 cycles
                    of `solve`, the residual falls every cycle, x within
                    1e-4 of max|x| of phase 5's plain x; setup seconds
                    beside phase 3's.
 24. gn_forms     — each GN form on a COO operator at 1024^2 against its
                    fused form on the kernels: `matvec_gnn` on A against
                    K1, on the stream leg's A_rcm against K2 and, with a
                    [N, 20] X, against K3; `residual_gnn` against K1 and
                    K4; the weighted norm (W = -A) against K1; 3 Jacobi
                    sweeps against K1 and K4 (3x the tolerance); degree-4
                    Chebyshev on Ac against K1 (4x); 10 power iterations
                    against K1 and K4 normalize (lambda rtol 1e-5, b 10x);
                    the launches of exactly those calls; `soc_classic`
                    (strong identical), `soc_sa` (rtol 1e-6) and
                    `direct_interp` (finite weights rtol 1e-5, non-finite
                    positions equal) against the setup's host formulas;
                    `sddmm` against the sampled dense U V^T on a 64^2
                    pattern; 100 small-band matrices batched with
                    per-graph globals against 100 single-graph calls.
 25. gn_times     — per form, the GN form and each fused form: ms per call
                    (CUDA events, 20 warm calls), the ratio, device busy
                    ms and device operations per call (profiler), the
                    port's kernel launches per call (the wrappers'
                    counts), the peak memory above the inputs; the host
                    formulas' seconds for SOC and direct interpolation.
The diffusion-coefficient model (no kernel of its own: dense layers, rolls
and reductions) and the evaluation tools of both learned models:
 26. diffusion_data  — `cosine_diffusion_dataset(1000, n=80, max_freq=3.0,
                    seed=41)` (host seconds, pool kind), the 700/200/100
                    split as `train` derives it; the off-diagonal pattern
                    takes the "grid" layout with K = 8.
 27. diffusion_serve — artifacts/diffusion/params.npz (1 external / 2
                    internal layers, 32 hidden, encoder (3, 16)) in
                    `DiffusionGNN` on the card: the grid-path loss of the
                    100 test graphs within rtol 1e-4 of the JAX package's
                    CPU value (JAX_CPU_TEST_LOSS) and within 10% of
                    results.json's (the gap reported); the grid path
                    against the edge path on 4 test graphs (rtol 1e-4,
                    atol 1e-5); ms per 100-graph forward (CUDA events, 10
                    warm calls), device ms and idle share (profiler), peak
                    memory.
 28. diffusion_eval  — `ood_extrapolation(n=80)` (6 decades) and
                    `freq_study_errors(n=80, max_freq=4.0)` (9 x 9) on the
                    card against the JAX package's CPU values (rtol 1e-4);
                    the largest relative gap to the artifacts'
                    (results.json's ood_loss_by_decade, freq_study.npz),
                    reported.
 29. diffusion_train — `train` on the card, 3 epochs of the same dataset at
                    results.json's configuration (batch 64, lr 1e-2, seed
                    41: 10 steps per epoch): finite losses, the train loss
                    lower in epoch 3 than in epoch 1, the run's peak memory
                    (200 validation graphs in one call); ms per step (CUDA
                    events, steps 2-10), idle share of 5 steps, a step's
                    peak memory.
 30. eigen        — the Jacobi test split as scripts/reproduce_jacobi.py
                    rebuilds it (small_band_dataset(1000, n=38,
                    h_low=5e-4, seed=54681), 800/50/150) and
                    `eigen_analysis(artifacts/jacobi/params.npz, max_graphs=8)`
                    with the MLP on the card: the non-learned arrays equal
                    rows 0-7 of test_eigenvalues.npz (rtol 1e-8); the
                    learned D^-1 within 3e-2 relative and the learned
                    spectra within the bound that gap implies (see
                    `eigen_phase`); per-row high-frequency damping beside
                    the npz's.
The rest of the port's single-device surface:
 31. bsr          — `to_bsr` of the stream phase's A_rcm (permute by its
                    RCM order), B = 128, on the card: blocks, bytes, slot
                    waste and host build seconds; the SpMV against K2 and
                    the M = 20 SpMM against K3 on the same CSR (rtol 1e-5,
                    atol 1e-5 max|y|), `diagonal()` exactly A_rcm's; both
                    times (L2 flushed) beside K2's and K3's, their bounds
                    and peak memory; scipy's RCM (`rcm_permutation`,
                    `permute`) on the shuffled A needs fewer blocks than
                    the shuffled pattern, which `to_bsr` refuses when it
                    needs more than max_blocks. TF32 must be off.
 32. cli          — `python -m gnnla_tpu_torch.cli` in subprocesses on the
                    card with a temporary cache, run at once with phase
                    33's: `diffusion --num-combos` (5), `diffusion`
                    combination 1 on 100 matrices at
                    n = 80 for 2 epochs (finite losses, the test loss
                    printed), `jacobi --epochs 1` at the defaults (1000
                    matrices, n = 38; finite losses, the test loss), and
                    `jacobi --num-matrices 12`, which must fail with the
                    split message before building data; seconds of each.
 33. examples     — `python -m gnnla_tpu_torch.examples.run_all` on the
                    card at default sizes: all 13 pass (the distributed
                    twin as a world of one NCCL rank); seconds of each.
Distribution on torch.distributed (`gnnla_tpu_torch/parallel/`), on a
world of one NCCL rank unless said otherwise:
 34. dist_init    — `initialize_distributed` through a file store,
                    `global_row_mesh()`; a 1-rank ring shift gives x back;
                    backend, world size, NCCL version.
 35. dist_spmv    — the row-partitioned COO path on phase 3's A: matvec
                    (rtol 1e-5, atol 1e-5), 10 Jacobi sweeps at omega 0.7
                    (1e-4, 1e-4), the norm (rtol 1e-5) and 30 power
                    iterations (lambda rtol 1e-4) against the port's
                    single-device twins (tests/test_parallel.py's
                    tolerances).
 36. dist_stream  — K2 per shard (`build_sharded_stream`, min_halo_tiles=1,
                    so h_tiles >= 1) on phase 12's shuffled A: one K2
                    launch per apply; y against K2 on the same RCM-ordered,
                    padded CSR whole (bitwise, or the largest relative gap
                    printed and held to 1e-5); x's cotangent against K2 on
                    that CSR's transpose (one backward launch on the
                    shard's transpose), the values' cotangent exactly
                    w[row] x[col] and its sum within 1e-5 of the host
                    pattern sum; the sharded apply's, the shard K2's and
                    the whole K2's times (L2 flushed) and `csr_spmv[A_rcm_
                    shard]`, `csr_spmv[A_rcm_shard_T, backward]` rows.
 37. dist_vcycle  — 3 cycles of `make_sharded_stream_vcycle` (exactly 7
                    K2 launches per cycle: the shard row's launches) and of
                    `make_sharded_vcycle` on phase 12's setup, each within
                    1e-4 of max|x| of the single-device `vcycle`; ms per
                    cycle beside phase 12's.
 38. dist_mgpcg   — `make_sharded_mg_pcg(flip_sign=True,
                    n_sharded_levels=2)` on phase 20's SA hierarchy (COO
                    levels): 15 +- 1 iterations to 1e-8 ||b||, x within
                    1e-4 of max|x| of the single-device `mg_pcg` on them;
                    ms per iteration beside phase 20's.
 39. dist_train   — `train_jacobi` at its defaults (phase 30's data) and
                    `train_diffusion` combination 1 at n = 80 on 100 of
                    phase 26's matrices, 1 epoch each, with a 1-rank "data"
                    mesh: losses within 1e-6 of the same runs without one.
 40. dist_2rank   — two spawned processes on the one card under gloo (the
                    card's tensors go through pinned host memory:
                    `staged_through_host`): the sharded COO matvec, K2
                    shards and 3 V-cycles on them at 256^2 shuffled, and 2
                    data-parallel Jacobi steps, each against the rank's
                    single-device result within the CPU tests'
                    tolerances; beside them two NCCL ranks on the card
                    report whether NCCL takes them. Correctness only.
 41. hw_check     — `run_sharded_hardware_check(device="cuda")`: its
                    dict.
The twins of the JAX repository's scratch/ scripts (gnnla_tpu_torch/
scratch/), on two fixtures built once: the Delaunay Laplacian of 1,048,576
points (proto_ellw.py's) and the k-NN-32 Laplacian of as many in RCM order
(bench_stream.py's):
 42. scratch_ellw  — K6 (`csrc/ellw_spmv.cu`) through `proto_ellw`: at its
                    default 16,384 points, on the 1M Delaunay Laplacian
                    and on the k-NN-32 Laplacian: error against scipy
                    below 1e-5 of max|y|, K6 bitwise its plain version in
                    the window path chosen from W, on x and on x with inf
                    and NaN, exactly 22 launches each; bitwise too in the
                    other path where W fits a block's shared memory and in
                    the earlier full-slot body; K, W, mean slots read,
                    padding and read waste; all of them timed flushed in
                    turns with K2 and cuSPARSE on the same matrix; the
                    bounds of the slots read and of the layout.
 43. scratch_gather — K7 and K8 (`csrc/gather_probe.cu`) through
                    `probe_dyngather` at its script's sizes: bitwise numpy
                    and the plain versions, 22 launches a probe, gathers
                    per second; K8 on its lane slabs, in turns with its
                    earlier design (bitwise too) and `torch.gather`, K7
                    against `torch.take` times vals (two calls);
                    `probe_gather`'s five formulations at n = 1M (plain
                    PyTorch).
 44. scratch_stream_probe — `probe_stream`: 2 x 1024 rows of 5 random
                    edges on K6 (`from_slots`) and K2 against the dense
                    A @ x (below 1e-5), then K6's row as in phase 42.
 45. scratch_ablate — K9 (`csrc/csr_ablate.cu`) through `ablate_stream` on
                    the scaled, RCM-ordered 1M Delaunay Laplacian: each
                    variant bitwise its plain version, `full` bitwise K2;
                    ms flushed and warm per variant, the stage costs as
                    differences from full; the same on phase 12's A_rcm,
                    the grid's operator, beside the Delaunay one.
 46. scratch_bench_stream — `bench_stream` on the k-NN-32 Laplacian: K2
                    against scipy and its plain version (1e-5), the VJP
                    against 2 A^T (A x) (1e-4), edges/s over chained
                    applies, the scipy ratio; a `csr_spmv[knn32_rcm]` row.
The artifact pipelines (`gnnla_tpu_torch.scripts`) at full width, cut in
depth, and the multichip dry run:
 47. repro_jacobi   — `reproduce_jacobi.pipeline` on phase 30's 1000
                    matrices at n = 38, widths (50, 20, 1), batch 100, 2
                    epochs: the six baselines within 1e-5 of
                    artifacts/jacobi/results.json (data-only: the JAX-CPU
                    gap is at most 2.9e-9, tests/test_torch_reproduce.py),
                    the learned numbers finite; ms per step.
 48. repro_smoother — `smoother_twogrid.rho_table` on the committed
                    params.npz and params_stable.npz, carried across, over
                    the first 30 test matrices: the omega = 2/3 rho mean and
                    max within 1e-6 of smoother_twogrid.json (JAX-CPU gap
                    0), the learned and stable means within 1e-4 of the
                    JAX-CPU constants (equal to the artifact's).
 49. repro_stable   — the stable twin's configuration, warm-started from
                    the committed params.npz (whose spectrum amplifies, so
                    the penalty is active: the first batch's loss with it
                    exceeds the loss without), 2 epochs: finite.
 50. repro_diffusion — the committed diffusion model through the twin's
                    OOD sweep and frequency study at n = 80 against the
                    JAX-CPU constants (1e-4); then the twin's pipeline, 2
                    epochs of the flagship combination on phase 26's
                    dataset: finite.
 51. repro_grid     — the five combinations at 300 x n = 48, 2 epochs
                    each: finite, best_index the argmin of the val loss.
 52. dryrun         — `graft_entry.dryrun_multichip(2)`, one call that
                    spawns two gloo ranks sharing card 0 (mesh data 2 x
                    rows 1; `parallel.spawn_ranks`), and
                    `dryrun_multichip(1)` inside this process's world of
                    one NCCL rank: the step's loss and new parameters
                    within 1e-6 of the step with no mesh, the flat-mesh
                    checks, the JAX line; K2's launches in the NCCL run
                    (its sharded stream matvec and stream V-cycle) and a
                    `csr_spmv[dryrun_stream_shard]` row.
The twin of the JAX repository's bench.py:
 53. bench_twin     — `python -m gnnla_tpu_torch.bench 512 100` in a
                    subprocess on the card: exit 0; every default section
                    in `sections_done`, none failed or skipped; every
                    `*_edges_per_s` finite and positive, every
                    `*_roofline_frac` at most 1.05, every in-run error
                    under the bench's own assert; a row for each kernel
                    path (K1 f32 and bf16, K4 over 100 steps, K2 on the
                    k-NN-32 fixture, K3 at M = 8) with launches in the run;
                    the headline and the rows' profiler device-busy ms
                    beside their wall ms. The rows join the kernels line.
The twin of the JAX repository's __graft_entry__.py:
 54. graft_entry    — `graft_entry.entry()` (the 16^2 Laplacian, CLJP
                    two-grid setup, plain DIA A and Ac, COO P) on the
                    card: b and x bitwise the CPU's, `fn(*args)` within
                    rtol 2e-5, atol 2e-5 * max|y| of `entry("cpu")`'s,
                    two calls within that of each other (the COO P's
                    index_add_ adds with atomics here; whether they are
                    bitwise equal is printed), no argument written; the
                    residual falls over 10 chained cycles; ms per call
                    (20 warm calls), the profiler's device-busy ms and
                    kernels per call, the idle share, setup seconds; no
                    hand-written kernel in the profile and no K1, K2 or
                    K4 counter moved; `python -m
                    gnnla_tpu_torch.graft_entry` exits 0 with the norm
                    line, the norm within 2e-5 of this one's, and the
                    norm of `program(fn)`'s replay within 2e-5 of it.
The twin of `jax.jit` and `lax.scan` (`utils/program.py`: one captured
CUDA graph a call, replayed after the first):
 55. programs       — seven paths through the entry points a user calls,
                    each as a program beside its eager body: the
                    contract's cycle (`program(flagship_cycle)`), the
                    fast cycle (`program(solve)` on K1 + K2, one cycle),
                    `AutoTwoGrid.run` (stencil, K4), `GeometricVCycle.run`
                    (K4), `program(amg_pcg)` on the fast setup (10
                    iterations) and `program(mg_pcg)` on the SA K1 levels
                    (15 iterations); and the geometric cycle on bf16
                    taps, whose smoother is phase 8's bf16 Jacobi call
                    (its launches over the replays, 2 a cycle, are
                    printed). Each: the first call captures (its
                    seconds and peak memory above the inputs, beside one
                    eager call's), a replay within rtol 1e-5 + 1e-5 max|y|
                    of the eager call (bitwise or not, printed, beside two
                    eager calls' gap); every K1, K2 and K4 counter set to
                    0, 20 replays, and each counter exactly 20 times what
                    one eager call moves it by (one capture, no other);
                    ms per call by CUDA events over 20 warm replays beside
                    the eager body's, the profiler's device-busy ms of
                    the replays (of the eager body where the profiler
                    sees no kernel in a replay; the source is printed),
                    the idle share. Then the guard: `mul_(1.0)` on the
                    fast A's diagonals, and the next call captures anew,
                    rebuilds A's K1 layout once and matches the eager
                    solve.
Then the script's seconds (`script`).
TF32 is off for matmuls and cuDNN: the MLP runs in full f32.
Then the `{"kernels": [...]}` line, and last `{"ok": true, "device": ...}`.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gnnla_tpu_torch import _build, native_ext
from gnnla_tpu_torch.core import (GNBlock, GraphState, batch_operators,
                                  graph_sizes, unbatch_vertices)
from gnnla_tpu_torch.core.block import DENSE_LAYOUT_MAX_EDGES
from gnnla_tpu_torch.models import (chebyshev, chebyshev_gnn, direct_interp,
                                    jacobi, jacobi_gnn, matrix_weighted_norm,
                                    matrix_weighted_norm_gnn, matvec,
                                    matvec_gnn, power_method,
                                    power_method_gnn, residual, residual_gnn,
                                    soc_classic, soc_sa)
from gnnla_tpu_torch.models.geometric import GeometricVCycle
from gnnla_tpu_torch.models.krylov import amg_pcg, cg, mg_pcg
from gnnla_tpu_torch.models.multigrid import (multigrid_cycle,
                                              setup_multigrid,
                                              setup_sa_multigrid,
                                              setup_with_dia_multigrid)
from gnnla_tpu_torch.models.trainable_jacobi import (TrainableJacobiMLP,
                                                     jacobi_diag_features,
                                                     predict_diag)
from gnnla_tpu_torch.models.vcycle import (AutoTwoGrid,
                                           _direct_interp_host,
                                           _direct_interp_raw,
                                           _soc_classic_host, setup_twogrid,
                                           setup_with_dia,
                                           setup_with_stream_p, solve)
from gnnla_tpu_torch.ops.dia import (DIAOperator, dia_matvec, dia_transpose,
                                     to_dia)
from gnnla_tpu_torch.ops.dia_spmv import (DiaKernelOperator,
                                          dia_kernel_operator)
from gnnla_tpu_torch.examples.run_all import MODULES as EXAMPLES
from gnnla_tpu_torch.ops.bsr import permute, rcm_permutation, to_bsr
from gnnla_tpu_torch.parallel import (
    build_sharded_stream, gather_vector, global_row_mesh,
    initialize_distributed, join_spawned, local_block, make_sharded_jacobi,
    make_sharded_matvec, make_sharded_mg_pcg, make_sharded_norm,
    make_sharded_power_method, make_sharded_stream_vcycle,
    make_sharded_vcycle, partition_rows, shard_vector, unshard_vector)
from gnnla_tpu_torch.parallel.collectives import axis_group, psum, ring_shift
from gnnla_tpu_torch.parallel.hardware_check import \
    run_sharded_hardware_check
from gnnla_tpu_torch.parallel.stream import _pad_square
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stencil import (stencil_apply_plain,
                                         stencil_matvec, stencil_transpose)
from gnnla_tpu_torch.ops.stencil_kernel import (TILES, StencilCall,
                                                StencilSpMV,
                                                make_stencil_jacobi,
                                                make_stencil_power,
                                                make_stencil_residual,
                                                make_stencil_spmv,
                                                shifts_tensor, stencil_args,
                                                stencil_buffers, stencil_cuda,
                                                stencil_form,
                                                stencil_launches, tile_form)
from gnnla_tpu_torch.ops.stream_op import (RectStreamOperator,
                                           StreamOperator, csr_pair)
from gnnla_tpu_torch.ops.stream_spmv import (BLOCK_NNZ, BLOCK_ROWS,
                                             LONG_ROW, WARP_ROW, CsrSpMV,
                                             csr_spmv_cuda, csr_spmv_plain,
                                             entry_rows, rcm_csr)
from gnnla_tpu_torch.problems import laplacian_2d, laplacian_nd
from gnnla_tpu_torch.problems.small_band import small_band_matrix_host
from gnnla_tpu_torch.ops.ellw_spmv import ELLW_SMEM_BYTES, ellw_cuda
from gnnla_tpu_torch.ops.gather_probe import (GatherProbe, axis0_cuda,
                                              axis0_path, axis0_plain,
                                              axis1_cuda, axis1_plain)
from gnnla_tpu_torch.ops.stream_ablate import (VARIANTS, StreamAblation,
                                               variant_bytes)
from gnnla_tpu_torch.scratch import (ablate_stream, bench_stream,
                                     probe_dyngather, probe_gather,
                                     probe_stream, proto_ellw)
from gnnla_tpu_torch import graft_entry
from gnnla_tpu_torch.utils.program import program
from gnnla_tpu_torch.scripts import (grid_diffusion, reproduce_diffusion,
                                     reproduce_jacobi,
                                     reproduce_jacobi_stable,
                                     smoother_twogrid)
from gnnla_tpu_torch.scripts._common import jacobi_test_split
from gnnla_tpu_torch.evaluation import (eigen_analysis, freq_study_errors,
                                        ood_extrapolation)
from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
from gnnla_tpu_torch.ops.band import choose_edge_layout
from gnnla_tpu_torch.training.checkpoints import (load_diffusion_params_npz,
                                                  load_params_npz)
from gnnla_tpu_torch.training.datasets import (cosine_diffusion_dataset,
                                               pool_kind, small_band_dataset)
from gnnla_tpu_torch.training.train_diffusion import (TrainDiffusionConfig,
                                                      edge_features,
                                                      loss_terms, make_apply,
                                                      make_apply_banded)
from gnnla_tpu_torch.training.train_diffusion import \
    train as train_diffusion
from gnnla_tpu_torch.training.spectral_loss import (
    damping_factor_gelfand, damping_factor_gelfand_spmm, uniform_probes)
from gnnla_tpu_torch.utils.health import (SHAPE as HEALTH_SHAPE,
                                          HealthCall, health_cuda,
                                          health_plain, health_probe)
from gnnla_tpu_torch.training.train_jacobi import (PlateauScale,
                                                   TrainJacobiConfig,
                                                   _draw_probes,
                                                   feature_stack,
                                                   make_loss_fn,
                                                   matrix_stack, train,
                                                   train_step)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
N_GRID = 1024
N_CYCLES = 5
RTOL = 1e-5
# normalize mode: per step, kernel and plain version each sum ||T x||^2 in
# a tree of depth < 32 (relative error < 32 * 2^-24 each) and take
# 1/sqrt within a few ulp; the scales they apply differ by less than
# 64 * 2^-24, and those differences add over the steps.
NORM_ULPS_PER_STEP = 64
K1_ROW = ("gnnla_tpu_torch/csrc/dia_spmv.cu",
          "gnnla_tpu/ops/pallas_spmv.py:41")
K2_ROW = ("csr_spmv", "gnnla_tpu_torch/csrc/csr_spmv.cu",
          "gnnla_tpu/ops/pallas_stream.py:479")
K4_ROW = ("gnnla_tpu_torch/csrc/stencil.cu",
          "gnnla_tpu/ops/pallas_stencil.py:126")
K5_ROW = ("gnnla_tpu_torch/csrc/health.cu", "bench.py:148")
K6_ROW = ("gnnla_tpu_torch/csrc/ellw_spmv.cu", "scratch/proto_ellw.py:66")
K7_ROW = ("gnnla_tpu_torch/csrc/gather_probe.cu",
          "scratch/probe_dyngather.py:14")
K8_ROW = ("gnnla_tpu_torch/csrc/gather_probe.cu",
          "scratch/probe_dyngather.py:67")
K9_ROW = ("gnnla_tpu_torch/csrc/csr_ablate.cu",
          "scratch/ablate_stream.py:27")
SCRATCH_N = 1 << 20
SCRATCH_ITERS = 20  # the twins' timed launches (each run: 1 + 1 + 20)
ABLATE_ITERS = 100  # per variant, warm and flushed: 1 + 2 * (1 + 100)
BLOCK_SMEM_MAX = 227 * 1024  # shared memory a block can opt in to
# the earlier K6 and K8 designs staged a window in shared memory up to the
# 48 KB a block has without opting in, else read x (win) through the
# read-only cache: the path their timing takes
EARLIER_SMEM_BYTES = 48 * 1024
BSR_BLOCK = 128
BSR_MAX_BLOCKS = 1 << 22  # to_bsr's default
PCG_ITERS = 30
# the distribution phases: results of earlier phases they reuse, the
# diffusion run's matrices, the two-rank grid side and time limit
SHARED = {}
DIST_DIFF_MATRICES = 100
DIST_2RANK_N = 256
DIST_2RANK_TIMEOUT_S = 240
CONV_SIZES = (64, 128, 256)
OMEGA = 2.0 / 3.0
M_PROBES = 20  # the trainer's m_probes: K3's width on the training path
# the fast Ac's nonzero (32-row tile, diagonal) pairs, counted on the host
# setup of phase 3, and a cap on the bytes its compact layout may store
AC_SEGMENTS_MAX = 378_269
AC_STORED_BYTES_MAX = 80e6
ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "jacobi")
DIFF_ARTIFACT = os.path.join(ROOT, "artifacts", "diffusion")
# the committed diffusion model (artifacts/diffusion/results.json)
DIFF_CFG = dict(n_layers_external=1, n_layers_internal=2, n_hidden=32,
                encoder=(3, 16))
DIFF_N = 80
DIFF_MATRICES = 1000
# The JAX package's values for the committed model on the CPU, from
# `references()` in tests/test_torch_chip_constants.py: the grid-path
# `loss_terms` of the 100-graph test split of cosine_diffusion_dataset(
# 1000, n=80, max_freq=3.0, seed=41), `ood_extrapolation(n=80)` and
# `freq_study_errors(n=80, max_freq=4.0)` (errors[ix, iy]).
JAX_CPU_TEST_LOSS = 0.002717547817155719
JAX_CPU_OOD_LOSS = [0.006867539137601852,
                    0.00950419157743454,
                    0.010520867072045803,
                    0.010939635336399078,
                    0.010986384004354477,
                    0.010991080664098263]
JAX_CPU_FREQ_ERRORS = [
    [0.001409116666764021, 0.0005773191805928946, 0.001171343494206667,
     0.002232806058600545, 0.0037843959871679544, 0.0057602813467383385,
     0.008268242701888084, 0.011322351172566414, 0.014707705937325954],
    [0.0005714561557397246, 0.0003221975639462471, 0.0005483783897943795,
     0.000947202555835247, 0.0015254224417731166, 0.0022761644795536995,
     0.0032175928354263306, 0.0043470109812915325, 0.005661407019942999],
    [0.0011491448385640979, 0.0005367913981899619, 0.000766088196542114,
     0.0011685780482366681, 0.0017506094882264733, 0.00250517507083714,
     0.003450836753472686, 0.004583138506859541, 0.005899796728044748],
    [0.002145924838259816, 0.000906778615899384, 0.001139896921813488,
     0.0015474268002435565, 0.0021348977461457253, 0.0028962877113372087,
     0.003846995998173952, 0.004983755759894848, 0.006303347647190094],
    [0.0035750041715800762, 0.0014341555070132017, 0.0016716340323910117,
     0.002085048006847501, 0.002678727963939309, 0.0034503021743148565,
     0.004405217710882425, 0.005547820590436459, 0.006869139615446329],
    [0.005450617987662554, 0.0021276241168379784, 0.002369298366829753,
     0.002789388643577695, 0.0033920302521437407, 0.004171018488705158,
     0.005129970144480467, 0.0062751686200499535, 0.007599781733006239],
    [0.00777528015896678, 0.0029854385647922754, 0.003231479087844491,
     0.0036569759249687195, 0.004264878574758768, 0.005048619583249092,
     0.006015310063958168, 0.007161677815020084, 0.008483413606882095],
    [0.010601948015391827, 0.004013735335320234, 0.004264005459845066,
     0.004694053437560797, 0.0053071510046720505, 0.006097098346799612,
     0.007064604666084051, 0.00821129884570837, 0.009530731476843357],
    [0.013858187012374401, 0.0052039953880012035, 0.005457418505102396,
     0.005890699103474617, 0.006504396442323923, 0.007299221586436033,
     0.00826410111039877, 0.009408739395439625, 0.0107170594856143]]
# the learned D^-1 against the artifact's (TPU, bf16-rounded matmuls): the
# carried weights reach 1.54e-2 on its 150 test matrices; phase 15 holds
# them within twice that
DINV_RTOL = 3e-2
EIGEN_EXACT = ("evals_A", "evals_DinvA", "evals_TwoThirds_DinvA",
               "evals_opt_DinvA", "diag_A", "diag_opt_Dinv")
# The committed Jacobi parameters' mean two-grid rho over the first 30 test
# matrices, by the JAX package on the CPU (`twogrid_references()` in
# tests/test_torch_chip_constants.py); smoother_twogrid.json holds the
# same values to the last bit.
JAX_CPU_CONVFAC_LEARNED_MEAN = 3.313771283992179
JAX_CPU_CONVFAC_STABLE_MEAN = 0.6661099199210567
# the artifact pipelines' phases: the data-only numbers against the
# committed artifacts (JAX-CPU gaps measured: at most 2.9e-9 and 0), the
# learned rho against the JAX-CPU constants
BASELINE_RTOL = 1e-5
RHO_W23_RTOL = 1e-6
RHO_LEARNED_RTOL = 1e-4
REPRO_EPOCHS = 2
DRYRUN_TIMEOUT_S = 180
# the entry contract's phase: its tolerance against the CPU (the port's
# fast-path tolerance), chained cycles, and the names of the hand-written
# kernels, none of which its path may launch
ENTRY_RTOL = 2e-5
ENTRY_CHAINED = 10
HAND_KERNELS = re.compile(
    r"dia_tiles|csr_spmv|csr_spmm|stencil_step|stencil_tile|norm_finalize|"
    r"scale_inplace|ellw_spmv|gather_axis|health_kernel")
# the bench twin's run in phase 53 (a grid side of 512, 100 applies), its
# time limit, and the bench's in-run asserts on its errors
BENCH_ARGS = ("512", "100")
BENCH_TIMEOUT_S = 300
BENCH_DEFAULT_SECTIONS = ("spmv", "general", "agg", "diffusion", "train",
                          "sharded", "solvers", "convergence", "spmm", "bsr")
BENCH_ERR_LIMITS = {"general_graph_relerr": 1e-4,
                    "agg4_unstructured_rel_err": 1e-5,
                    "general_graph_spmm_relerr": 1e-4,
                    "general_graph_bsr_relerr": 1e-4,
                    "sharded_stream_spmv_rel_err": 1e-5,
                    "sharded_stream_vjp_x_rel_err": 1e-5,
                    "sharded_vcycle_rel_err": 1e-4,
                    "sharded_stencil_rel_err": 1e-5}
# phase 55: replay against eager (the COO P's index_add_ adds with atomics
# on the card, so not bitwise), replays counted and timed, the two Krylov
# solves' iterations
PROGRAM_RTOL = 1e-5
PROGRAM_REPLAYS = 20
PROGRAM_AMG_PCG_ITERS = 10
PROGRAM_MG_PCG_ITERS = 15
BENCH_KERNEL_ROWS = ("dia_spmv[bench]", "dia_spmv_bf16[bench]",
                     "stencil[bench,100 steps]", "csr_spmv[bench,knn32]",
                     "csr_spmm[bench,M=8]")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean ms of one call of fn with the L2 cache flushed before it. The
    flush reads a buffer larger than L2, so it leaves no dirty lines for
    the timed call to write back; it is enqueued first, so the host
    enqueues the timed call while the device is still busy and no host
    gap lands inside the events."""
    fn()
    total = 0.0
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def cold_ms_turns(fns: dict, iters: int, flush: torch.Tensor) -> dict:
    """Median ms of one call of each fn, timed as cuda_ms_cold times one
    but behind two flushes, the fns taken in turns in every round, so that
    all meet the card in the same state. The second flush gives the host
    time to enqueue the call before the card reaches it, and the median
    keeps a round that the host still held up from moving the result."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(iters):
        for key, fn in fns.items():
            flush.sum()
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    return {k: float(np.median(v)) for k, v in times.items()}


def bound(bytes_moved: float, flops: float):
    """(ms, "bytes"|"operations"): the least time for the work."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def require(cond: bool, what) -> None:
    """A check that stays under `python -O` (unlike assert)."""
    if not cond:
        raise AssertionError(what)


def compare(got: torch.Tensor, want: torch.Tensor, what: str,
            rtol: float = RTOL, atol_scale: float = None) -> dict:
    """Elementwise |got - want| <= rtol |want| + atol_scale max|want|
    (atol_scale defaults to rtol)."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    atol = (rtol if atol_scale is None else atol_scale) * scale
    ok = bool((err <= rtol * want.abs() + atol).all())
    out = dict(what=what, max_abs_err=float(err.max()),
               max_rel_err=float(err.max()) / scale if scale else 0.0)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel disagrees with plain {out}")
    return out


def csr_tensor(op) -> torch.Tensor:
    """torch's sparse CSR view of an operator's CSR arrays (cuSPARSE)."""
    with warnings.catch_warnings():  # beta-state notice of sparse CSR
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(op.row_ptr.long(), op.cols.long(),
                                       op.vals, size=op.shape)


def csr_raw(lib, csr, x: torch.Tensor):
    """(raw launch of K2 on the CsrSpMV `csr` and x, bytes, flops): each
    input read once (the CSR, its row blocks, x), the output written
    once."""
    y = torch.empty(csr.shape[0], device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    blocks = csr.row_blocks

    def raw():
        _build.check(lib.csr_spmv_f32(
            csr.row_ptr.data_ptr(), csr.cols.data_ptr(), csr.vals.data_ptr(),
            csr.shape[0], blocks.data_ptr(), blocks.shape[0] - 1, csr.nnz,
            x.data_ptr(), y.data_ptr(), stream), "K2 raw")
    r_, c_ = csr.shape
    return raw, (csr.nnz * 8 + (r_ + 1) * 4 + blocks.shape[0] * 4 + c_ * 4
                 + r_ * 4), 2 * csr.nnz


def short_row_blocks(row_ptr: torch.Tensor,
                     budget: int = BLOCK_NNZ) -> torch.Tensor:
    """K2's row blocks before warp blocks: every row of more than LONG_ROW
    nonzeros alone, the others in runs within one window of budget -
    LONG_ROW nonzeros and one aligned run of BLOCK_ROWS rows."""
    rp = row_ptr.long()
    n = rp.shape[0] - 1
    rows = torch.arange(n, device=rp.device)
    long_ = rp.diff() > LONG_ROW
    window = rp[:-1] // (budget - LONG_ROW)
    cut = torch.ones(n, dtype=torch.bool, device=rp.device)
    cut[1:] = (long_[1:] | long_[:-1] | (window[1:] != window[:-1])
               | (rows[1:] % BLOCK_ROWS == 0))
    return torch.cat([torch.nonzero(cut).reshape(-1),
                      rows.new_full((1,), n)]).to(torch.int32)


def k2_fields(csr) -> dict:
    """A K2 row's fields beside its times: the row blocks one CUDA block
    each takes (and as many before warp blocks), the rows and nonzeros of
    the warp blocks, and the rows a whole block sums."""
    return dict(row_blocks=csr.row_blocks.shape[0] - 1,
                row_blocks_before=short_row_blocks(csr.row_ptr).shape[0] - 1,
                warp_rows=csr.warp_rows, warp_nnz=csr.warp_nnz,
                long_rows=csr.long_rows)


def dia_raw(lib, tiles, x: torch.Tensor, b: torch.Tensor = None,
            d: torch.Tensor = None):
    """(raw launch of K1 on the compact layout `tiles` (f32 or bf16
    values) and x, bytes, flops): plain, or with b the residual form, with
    b and d the Jacobi form (omega 0.7). The layout, x, b and d read once,
    the result written once; 2 flops per stored value and, per row, 1
    (b - y) in the residual form, 5 (rcp, scale, b - y, w * r, x + t) in
    the Jacobi form."""
    out = torch.empty(tiles.n, device=x.device)
    fn = (lib.dia_spmv_f32 if tiles.seg_vals.dtype == torch.float32
          else lib.dia_spmv_bf16)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [None if v is None else v.data_ptr() for v in (x, b, d)]

    def raw():
        _build.check(fn(tiles.seg_ptr.data_ptr(), tiles.seg_off.data_ptr(),
                        tiles.seg_vals.data_ptr(), tiles.n, int(tiles.split),
                        tiles.offsets.data_ptr(), tiles.offsets.shape[0],
                        tiles.state.data_ptr() if tiles.repair else None,
                        *ptrs, 0.7, out.data_ptr(), stream), "K1 raw")
    n_read = sum(p is not None for p in ptrs)
    per_row = 0 if b is None else 1 if d is None else 5
    return (raw, tiles.nbytes + (n_read + 1) * tiles.n * 4,
            2 * tiles.seg_vals.numel() + per_row * tiles.n)


def sa_fused_forms(op, d: torch.Tensor, x: torch.Tensor,
                   b: torch.Tensor) -> dict:
    """{form: (fused, eager)}: K1's Jacobi form (omega 0.7, the cycle's,
    the smoother's diagonal d) and residual form through the operator,
    and the eager chain each replaces over plain K1."""
    return dict(
        jacobi=(lambda: op.jacobi_sweep(b, x, 0.7, d),
                lambda: x + (0.7 / d) * (b - op.launch(x))),
        residual=(lambda: op.residual(b, x), lambda: b - op.launch(x)))


def sa_fused_bitwise(mg, tag: str) -> list:
    """K1's Jacobi and residual forms on every K1 smoothing level of `mg`
    (each level but the coarsest), each bitwise the eager chain over plain
    K1 on random x and b; per level its rows and the instantiation the
    solve launches there (split shape, non-finite repair)."""
    gen = np.random.default_rng(47)
    out = []
    for lvl, op in enumerate(mg.As[:-1]):
        if not isinstance(op, DiaKernelOperator):
            continue
        d = mg.diags[lvl]
        x, b = (torch.from_numpy(gen.standard_normal(op.n).astype(
            np.float32)).to(d.device) for _ in range(2))
        for form, (fused, eager) in sa_fused_forms(op, d, x, b).items():
            got, want = fused(), eager()
            require(torch.equal(got, want), (tag, lvl, form, float(
                (got - want).abs().max())))
        out.append(dict(level=lvl, rows=op.n, split_form=op.tiles.split,
                        repair=op.tiles.repair))
    return out


def sa_fused_rows(mg, tag: str, lib, flush) -> list:
    """K1's Jacobi and residual forms on SA levels 0 and 1 of `mg` (checked
    bitwise by `sa_fused_bitwise`): each one's raw launch, K1 with the
    chain's elementwise kernels (five for a sweep: omega / d as reciprocal
    and scale, b - y, w * r, x + t; one, b - y, for the residual) and plain
    K1 alone, flushed, in turns, beside the bound of the fused form's
    bytes."""
    rows = []
    gen = np.random.default_rng(43)
    for lvl in (0, 1):
        op, d = mg.As[lvl], mg.diags[lvl]
        require(isinstance(op, DiaKernelOperator), (tag, lvl, type(op)))
        x, b = (torch.from_numpy(gen.standard_normal(op.n).astype(
            np.float32)).to(d.device) for _ in range(2))
        k1_raw, _, _ = dia_raw(lib, op.tiles, x)
        for form, (_, eager) in sa_fused_forms(op, d, x, b).items():
            raw, bytes_moved, flops = dia_raw(
                lib, op.tiles, x, b, d if form == "jacobi" else None)
            ms = cold_ms_turns(dict(fused=raw, unfused=eager, k1=k1_raw),
                               20, flush)
            bound_ms, bound_by = bound(bytes_moved, flops)
            rows.append(dict(
                name=f"dia_tiles_{form}[SA{tag}.A{lvl}]", route="cuda",
                source=K1_ROW[0], replaces=f"gnnla_tpu/models/{form}.py "
                "(XLA's elementwise ops after the SpMV)",
                launches_per_cycle=2 if form == "jacobi" else 1,
                bitwise=True, ms=ms["fused"], unfused_ms=ms["unfused"],
                k1_ms=ms["k1"], bound_ms=bound_ms, bound_by=bound_by,
                rows=op.n, segments=op.tiles.n_segs,
                split_form=op.tiles.split))
    return rows


def k1_fields(tiles, k: int, nnz: int) -> dict:
    """A K1 row's fields beside `bound_ms` (the compact layout's): the
    bound of a dense walk (all K diagonals over n rows, the layout before
    the compact one), the floor of any format (the nonzero values, x and
    y), the segment count and the bytes the layout stores."""
    n, d = tiles.n, tiles.seg_vals.element_size()
    return dict(dense_bound_ms=bound(k * n * d + 2 * n * 4 + 4 * k,
                                     2 * k * n)[0],
                nnz_floor_ms=bound(nnz * d + 2 * n * 4, 2 * nnz)[0],
                segments=tiles.n_segs, stored_bytes=tiles.nbytes,
                split_form=tiles.split)


def nonfinite_probe(tiles, n_cols: int, seed: int):
    """(columns, rows): up to n_cols columns of x, each reached by its row
    only through a (tile, diagonal) segment the compact layout `tiles`
    skipped, in range; an inf or NaN there makes the reference's row NaN,
    and only K1's repair does so on the card. Empty when the layout skips
    no segment in range (as on the Laplacian, whose skipped segments all
    lie past the grid's first or last row)."""
    dev, n = tiles.seg_ptr.device, tiles.n
    offs = tiles.offsets.long()
    n_tiles = tiles.seg_ptr.shape[0] - 1
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                   tiles.seg_ptr.diff().long(),
                                   output_size=tiles.n_segs)
    stored = torch.zeros(n_tiles, offs.shape[0], dtype=torch.bool,
                         device=dev)
    stored[tile, torch.searchsorted(offs, tiles.seg_off.long())] = True
    lane = torch.arange(32, device=dev)
    rng = np.random.default_rng(seed)
    cols, rows = [], []
    for k in rng.permutation(offs.shape[0]).tolist():
        off = int(offs[k])
        r = (torch.nonzero(~stored[:, k])[:, None] * 32 + lane).reshape(-1)
        r = r[(r < n) & (r + off >= 0) & (r + off < n)]
        if r.numel():
            row = int(r[int(rng.integers(r.numel()))])
            if row + off not in cols:
                cols.append(row + off)
                rows.append(row)
        if len(cols) == n_cols:
            break
    return cols, rows


def power_law_csr(n: int, seed: int):
    """A scipy CSR with Zipf row lengths from 1 to 10,000 (one row of each
    pinned), columns anywhere (distinct in a row), normal values: K2's
    long rows, summed by whole blocks, and rows of 65 to 256 nonzeros, by
    warps."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, n), 10_000)
    lens[[7, n // 2]] = [10_000, 1]
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, rows.size)
    long_ = np.flatnonzero(lens > 500)
    starts = np.concatenate([[0], np.cumsum(lens)])
    for r in long_:  # distinct columns where duplicates would be many
        cols[starts[r]:starts[r + 1]] = rng.choice(n, lens[r], replace=False)
    A = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(n, n))
    A.sort_indices()
    return A


def sa_coarse_csr(n: int, seed: int):
    """A scipy CSR shaped as the 3-D SA hierarchy's second coarse level:
    rows of 33 to 120 nonzeros, runs of 1 to 40 rows longer than 64 (K2's
    warp blocks) between runs of 1 to 30 shorter ones, distinct columns in
    a band of 600 around the diagonal, normal values."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    lens, long_ = [], True
    while len(lens) < n:
        k = int(rng.integers(1, 41 if long_ else 31))
        lens += (rng.integers(65, 121, k) if long_
                 else rng.integers(33, 65, k)).tolist()
        long_ = not long_
    lens = np.asarray(lens[:n])
    rows = np.repeat(np.arange(n), lens)
    lo = np.clip(np.arange(n) - 300, 0, max(n - 600, 0))
    cols = np.concatenate([a + rng.choice(min(n, a + 600) - a, k,
                                          replace=False)
                           for a, k in zip(lo, lens)])
    A = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(n, n))
    A.sort_indices()
    return A


def csr_sequential(op, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for the CsrSpMV `op`, summed in CSR order with one multiply
    and one add per step (separate PyTorch ops: no fused multiply-add),
    position by position over the rows padded to their longest; a padded
    position leaves the sum as it is. K3's arithmetic, and K2's on rows
    of at most 64 nonzeros (X [n, 1]), bit for bit."""
    lens = op.row_ptr.diff().long()
    steps = torch.arange(int(lens.max()), device=X.device)
    live = steps[None, :] < lens[:, None]
    pos = torch.where(live, op.row_ptr[:-1].long()[:, None] + steps, 0)
    cols, vals = op.cols.long()[pos], op.vals[pos]
    acc = X.new_zeros((op.shape[0], X.shape[1]))
    for p in range(steps.shape[0]):
        acc = torch.where(live[:, p:p + 1],
                          acc + vals[:, p:p + 1] * X[cols[:, p]], acc)
    return acc


def form_fields(call) -> dict:
    """A K4 row's form, tile and halo (`StencilCall.form`)."""
    f = call.form
    return dict(form=f.form, tile=f.tile, halo=f.halo, vec=f.vec)


def library_call(op, x2d: torch.Tensor, c2d=None):
    """One PyTorch call computing a one-step K4 row's function on op's CSR:
    y = op x (plain), or y = c - op x (the affine residual, whose taps are
    -op), with `torch.addmv` on cuSPARSE. A yardstick only."""
    mat, x = csr_tensor(op), x2d.reshape(-1)
    if c2d is None:
        return lambda: mat @ x
    c = c2d.reshape(-1)
    return lambda: torch.addmv(c, mat, x, alpha=-1)


def profile_cycles(run_cycles) -> dict:
    """Device time by kernel per cycle over 3 cycles of run_cycles(n).
    The first profile of a process starts the tracer and is thrown away."""
    from torch.profiler import ProfilerActivity, profile
    for cycles in (1, 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_cycles(cycles)
            torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernels are the events on the CUDA side, less the ranges of
        # `record_function` shown there (the port's `gnnla.*` spans); their
        # self time is the device time (attribute names vary by release)
        if getattr(ev, "device_type", None) != \
                torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((ev.key[:60], ev.count / 3, dev_us / 3e3))
    rows.sort(key=lambda r: -r[2])
    return dict(device_busy_ms_per_cycle=sum(r[2] for r in rows),
                launches_per_cycle=sum(r[1] for r in rows),
                kernel_names=sorted(r[0] for r in rows),
                top_kernels_per_cycle=[
                    dict(kernel=k, launches=c, ms=m) for k, c, m in rows[:12]])


def grid_path(A, plain, b, x_plain, flush, smi) -> list:
    """Phases 7-11 (the grid path on kernel K4); returns the K4 rows of
    the kernels line, one per shape the grid path launches, and the rows
    of the shapes it does not launch (normalize, bf16 taps, A^T's taps)."""
    dev = b.device
    n = A.n_rows
    gs = (N_GRID, N_GRID)

    # ------------------------------------------------------ grid_setup
    t0 = time.perf_counter()
    alt = setup_twogrid(A, theta=0.25, splitting="alternating")
    t_alt = time.perf_counter() - t0
    t0 = time.perf_counter()
    geo = GeometricVCycle(A, gs, setup=alt)
    t_geo = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = AutoTwoGrid(plain)
    t_auto = time.perf_counter() - t0
    require(auto.layout == "stencil", (auto.layout, auto.why))
    sv = auto._stencil
    # on the card the stencil leg's Ac (the DIA twin, its dense diagonals
    # on the host) runs on K1 and its P on K2
    require(type(sv.setup.Ac) is DiaKernelOperator, type(sv.setup.Ac))
    require(sv.setup.Ac.diags.device.type == "cpu", sv.setup.Ac.diags.device)
    require(type(sv.setup.P) is RectStreamOperator, type(sv.setup.P))
    SHARED.update(geo=geo, auto=auto)  # phase 55 runs both as programs
    ac_taps = geo._ac_call.taps
    emit(dict(phase="grid_setup", alternating_setup_s=t_alt,
              geometric_build_s=t_geo, auto_build_s=t_auto,
              auto_layout=auto.layout, auto_why=auto.why,
              ac_grid=list(ac_taps.shape[1:]), ac_K=ac_taps.shape[0],
              ac_nnz=alt.Ac.nnz, p_offset_classes=len(geo._p_offsets),
              jacobi_K=geo._pre.taps.shape[0],
              residual_K=geo._res.taps.shape[0],
              auto_dia_Ac_K=len(sv.setup.Ac.offsets)))

    # ----------------------------------------- K4 vs its plain version
    gen = np.random.default_rng(11)

    def grid_vec(shape):
        return torch.from_numpy(
            gen.standard_normal(shape).astype(np.float32)).to(dev)

    x_f, c_f = grid_vec(gs), grid_vec(gs)
    x_c = grid_vec(tuple(ac_taps.shape[1:]))
    power = make_stencil_power(A, gs, n_iters=10)
    jac16 = make_stencil_jacobi(A, gs, omega=0.7, n_iters=3, diag=alt.diag,
                                tap_dtype=torch.bfloat16)
    # the 3-step SpMV's x cotangent: plain mode on the transposed taps
    sp3 = make_stencil_spmv(A, gs, 3)
    _, planes_t = stencil_transpose(sp3.shifts, sp3.taps)
    spmv_t = StencilCall(sp3.shifts_t, planes_t.contiguous(), 3, "plain")
    shapes = {  # row -> (K4 call, x, c, operator of the one-call library
        #        yardstick); the first three are the geometric cycle's own
        "Ac_plain": (geo._ac_call, x_c, None, alt.Ac),
        "jacobi_affine": (geo._pre._call, x_f, c_f, None),
        "residual_affine": (geo._res._call, x_f, c_f, A),
        "power_normalize": (power._call, x_f, None, None),
        "jacobi_affine_bf16": (jac16._call, x_f, c_f, None),
        "plain_3step_T": (spmv_t, x_f, None, None),
    }
    errs, outs = {}, {}
    for key, (call, xin, cin, _) in shapes.items():
        rtol = (call.n_steps * NORM_ULPS_PER_STEP * 2.0 ** -24
                if call.mode == "normalize" else RTOL)
        got = call(xin, cin)
        want = call.plain(xin, cin)
        torch.cuda.synchronize()
        outs[key] = got
        errs[key] = dict(compare(got, want, key, rtol), rtol=rtol,
                         mode=call.mode, n_steps=call.n_steps,
                         tap_dtype=str(call.taps.dtype),
                         K=call.taps.shape[0], **form_fields(call),
                         bitwise_equal=bool(torch.equal(got, want)))
        # at 1024^2 the multi-step plain and affine calls run every step
        # in one launch (the tile form), the others per step
        require(call.form.form == ("tile" if call.mode != "normalize"
                                   and call.n_steps > 1 else "step"),
                (key, call.form))
        if call.mode != "normalize":  # rounded like the plain version
            require(errs[key]["bitwise_equal"], (key, errs[key]))
    # the tile form bitwise in plain and affine mode, at 1 and 3 steps, f32
    # and bf16 (forced on the one-step calls, which run per step); a reach
    # of 40 at 3 steps takes the per-step form
    reach40 = [(0, 0), (1, 0), (N_GRID - 1, 0), (40, 3), (N_GRID - 40, 1)]
    more = {  # name -> (taps, shifts, x, c, n_steps, mode)
        "plain_1step_f32": (ac_taps, geo._ac_call.shifts, x_c, None, 1,
                            "plain"),
        "plain_1step_bf16": (ac_taps.to(torch.bfloat16),
                             geo._ac_call.shifts, x_c, None, 1, "plain"),
        "plain_3step_bf16": (spmv_t.taps.to(torch.bfloat16), spmv_t.shifts,
                             x_f, None, 3, "plain"),
        "affine_1step_f32": (geo._res.taps, geo._res._call.shifts, x_f, c_f,
                             1, "affine"),
        "affine_1step_bf16": (geo._res.taps.to(torch.bfloat16),
                              geo._res._call.shifts, x_f, c_f, 1, "affine"),
        "affine_3step_bf16": (jac16.taps, jac16._call.shifts, x_f, c_f, 3,
                              "affine"),
        "reach40_plain_3step": (torch.from_numpy(gen.uniform(
            -0.3, 0.3, (5,) + gs).astype(np.float32)).to(dev), reach40, x_f,
            None, 3, "plain"),
    }
    checks = {}
    for key, (taps, shifts, xin, cin, n_steps, mode) in more.items():
        grid = tuple(taps.shape[1:])
        form = (stencil_form(shifts, grid, n_steps, mode, taps.dtype)
                if key.startswith("reach") else
                tile_form(shifts, grid, n_steps, taps.dtype, TILES[0]))
        got = stencil_cuda(taps.contiguous(), shifts_tensor(shifts), xin,
                           n_steps, mode, cin, form)
        want = stencil_apply_plain(taps, shifts, xin, n_steps, mode, cin)
        checks[key] = dict(bitwise_equal=bool(torch.equal(got, want)),
                           form=form.form, tile=form.tile, halo=form.halo,
                           vec=form.vec)
        require(checks[key]["bitwise_equal"], (key, checks[key]))
        require(form.form == ("step" if key.startswith("reach") else "tile"),
                (key, form))
    del more
    emit(dict(phase="grid_kernels", atol="rtol * max|y|",
              results=list(errs.values()), tile_form_checks=checks))

    # ------------------------------------------------------------ grid
    x = torch.zeros(n, device=dev)
    calls = geo.kernel_calls()
    for call in calls:
        call.launches = 0
    res = [float(torch.linalg.vector_norm(b - A.matvec(x)))]
    for _ in range(N_CYCLES):
        x = geo.run(b, x)
        # the plain COO A (index_add_) reads the residual: no K4 launch
        res.append(float(torch.linalg.vector_norm(b - A.matvec(x))))
    torch.cuda.synchronize()
    launches = {"Ac_plain": geo._ac_call.launches,
                "jacobi_affine": geo._pre._call.launches,
                "residual_affine": geo._res._call.launches}
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)
    # one launch per call in the tile form: 1 pre + 1 residual + 4 Ac + 1
    # post per cycle
    want_launches = {"Ac_plain": 4 * N_CYCLES, "jacobi_affine": 2 * N_CYCLES,
                     "residual_affine": N_CYCLES}
    require(launches == want_launches, (launches, want_launches))
    require(sum(c.launches for c in calls) == 7 * N_CYCLES, launches)
    require(x.shape == (n,) and bool(torch.isfinite(x).all()),
            "x must be finite, of shape [n]")
    x_gen = solve(alt, b, torch.zeros(n, device=dev), n_cycles=N_CYCLES)
    rel = float((x - x_gen).abs().max() / x_gen.abs().max())
    require(rel <= 1e-4, rel)
    # small input: the card's kernel path against the port's CPU path
    b_s = np.random.default_rng(5).standard_normal(64 * 64).astype(
        np.float32)

    def small(device):
        g = GeometricVCycle(laplacian_2d(64, device=device).eliminate_zeros(),
                            (64, 64))
        bb = torch.from_numpy(b_s).to(device)
        y = torch.zeros_like(bb)
        for _ in range(4):
            y = g.run(bb, y)
        return y.cpu()

    x_s, x_h = small(dev), small("cpu")
    rel_small = float((x_s - x_h).abs().max() / x_h.abs().max())
    require(rel_small <= 2e-5, rel_small)
    emit(dict(phase="grid", cycles=N_CYCLES, residual_norms=res,
              launches=launches, k4_launches_per_cycle=sum(
                  launches.values()) // N_CYCLES,
              rel_err_vs_generic_plain_cycle=rel,
              rel_err_64sq_vs_cpu=rel_small))

    # ------------------------------------------------------------ auto
    x = torch.zeros(n, device=dev)
    a_counted = {"jacobi_affine": sv._pre._call,
                 "residual_affine": sv._res._call, "k1_Ac": sv.setup.Ac,
                 "k2_Pt": sv.setup.P.bwd, "k2_P": sv.setup.P.fwd}
    for obj in a_counted.values():
        obj.launches = 0
    res_a = [float(torch.linalg.vector_norm(b - A.matvec(x)))]
    for _ in range(N_CYCLES):
        x = auto.run(b, x)
        res_a.append(float(torch.linalg.vector_norm(b - A.matvec(x))))
    torch.cuda.synchronize()
    a_launches = {k: obj.launches for k, obj in a_counted.items()}
    require(all(r1 < r0 for r0, r1 in zip(res_a, res_a[1:])), res_a)
    require(a_launches == {"jacobi_affine": 2 * N_CYCLES,
                           "residual_affine": N_CYCLES,
                           "k1_Ac": 4 * N_CYCLES, "k2_Pt": N_CYCLES,
                           "k2_P": N_CYCLES}, a_launches)
    require(bool(torch.isfinite(x).all()), "auto x must be finite")
    rel_a = float((x - x_plain).abs().max() / x_plain.abs().max())
    require(rel_a <= 1e-4, rel_a)
    # the same stencil cycle with the coarse correction on the plain path
    # (plain DIA Ac, COO P): only K1's and K2's sum order differ
    sv_plain = copy.copy(sv)
    sv_plain.setup = dataclasses.replace(sv.setup, Ac=to_dia(auto.setup.Ac),
                                         P=auto.setup.P)
    x_leg = torch.zeros(n, device=dev)
    for _ in range(N_CYCLES):
        x_leg = sv_plain.cycle(b, x_leg)
    leg_err = compare(x, x_leg, "the stencil leg's K1/K2 coarse "
                      "correction against the plain one", rtol=RTOL)
    emit(dict(phase="auto", layout=auto.layout, cycles=N_CYCLES,
              residual_norms=res_a, launches=a_launches,
              k4_launches_per_cycle=(a_launches["jacobi_affine"]
                                     + a_launches["residual_affine"])
              // N_CYCLES,
              rel_err_vs_plain_cycle=rel_a,
              vs_plain_coarse_path=dict(leg_err, rtol=RTOL)))

    # ------------------------------------------------------ grid_times
    x0 = torch.zeros(n, device=dev)
    ms_geo = cuda_ms(lambda: geo.run(b, x0), iters=20)
    ms_auto = cuda_ms(lambda: auto.run(b, x0), iters=20)
    ms_gen = cuda_ms(lambda: solve(alt, b, x0, n_cycles=1), iters=3,
                     warmup=1)
    xc = torch.zeros(sv.setup.Ac.n, device=dev)
    ms_auto_ac = cuda_ms(lambda: sv.setup.Ac.matvec(xc), iters=20)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    rows, off_path, warm, lib_errs, k4_ms_cycle = [], [], {}, {}, 0.0
    for key, (call, xin, cin, lib_op) in shapes.items():
        taps = call.taps
        bufs = stencil_buffers(xin, call.n_steps, call.mode, call.form)
        args = stencil_args(taps, call.shifts_host, xin, call.n_steps,
                            call.mode, cin, *bufs, call.form)

        def raw(args=args):
            _build.check(lib.stencil_f32(*args, stream), "K4 raw")
        k, pts = taps.shape[0], xin.numel()
        # each input read once, the output written once per fused call
        bytes_moved = (k * taps.element_size()
                       + 4 * (2 + (cin is not None))) * pts
        flops = call.n_steps * pts * (2 * k + (call.mode == "affine")
                                      + 3 * (call.mode == "normalize"))
        bound_ms, bound_by = bound(bytes_moved, flops)
        library_ms = None
        if lib_op is not None:  # the one-step rows: one cuSPARSE call
            lib_fn = library_call(lib_op, xin, cin)
            lib_errs[key] = compare(lib_fn(), outs[key].reshape(-1),
                                    f"library yardstick of {key}")
            library_ms = cuda_ms_cold(lib_fn, 20, flush)
        row = dict(
            name=f"stencil[{key}]", route="cuda",
            source=K4_ROW[0], replaces=K4_ROW[1],
            launches=launches.get(key, 0),
            max_abs_err=errs[key]["max_abs_err"],
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: call.plain(xin, cin), 5, flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            **form_fields(call))
        per_call = stencil_launches(call.mode, call.n_steps, call.form.form)
        # back to back, L2 warm: the raw launch (median of 5 windows) and
        # the wrapper; the profiler's device time of one call, which no
        # host delay can inflate
        warm[key] = dict(raw_ms=float(np.median([cuda_ms(raw, iters=20)
                                                 for _ in range(5)])),
                         wrapper_ms=cuda_ms(lambda: call(xin, cin),
                                            iters=50),
                         device_ms_per_call=profile_cycles(
                             lambda c: [raw() for _ in range(c)])[
                                 "device_busy_ms_per_cycle"],
                         launches_per_call=per_call,
                         calls_per_cycle=launches.get(key, 0) // (
                             N_CYCLES * per_call))
        (rows if key in launches else off_path).append(row)
        k4_ms_cycle += row["ms"] * warm[key]["calls_per_cycle"]
    prof = profile_cycles(
        lambda c: [geo.run(b, x0) for _ in range(c)])
    emit(dict(phase="grid_times", ms_per_cycle_geometric=ms_geo,
              ms_per_cycle_auto_stencil=ms_auto,
              ms_per_cycle_generic_alternating_plain=ms_gen,
              auto_k1_Ac_apply_ms=ms_auto_ac,
              k4_flushed_ms_per_geometric_cycle=k4_ms_cycle,
              l2_warm=warm, off_main_path=off_path,
              library_vs_kernel=lib_errs,
              geometric_device_busy_ms_per_cycle=prof[
                  "device_busy_ms_per_cycle"],
              geometric_idle_share=1.0 - prof["device_busy_ms_per_cycle"]
              / ms_geo,
              geometric_top_kernels_per_cycle=prof["top_kernels_per_cycle"],
              nvidia_smi=smi))
    return rows, off_path


def stream_path(A, flush, smi) -> list:
    """Phase 12 (`AutoTwoGrid`'s "stream" leg: A on kernel K2 in RCM order,
    perm/iperm gathers around it); returns the K2 rows of that leg, the
    shuffled operator and its `StreamOperator`."""
    dev, n = A.device, A.n_rows
    rows, cols, vals = A.host_coo()
    # the same Laplacian with its vertices shuffled: no grid, no band, so
    # the stencil and DIA probes refuse it and RCM restores a narrow band
    new = np.argsort(np.random.default_rng(0).permutation(n))
    A_p = SparseOperator.from_coo(new[rows], new[cols], vals, A.shape,
                                  device=dev)
    t0 = time.perf_counter()
    setup_p = setup_twogrid(A_p, theta=0.25, splitting="cljp", seed=0)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = AutoTwoGrid(setup_p)
    t_auto = time.perf_counter() - t0
    require(auto.layout == "stream", (auto.layout, auto.why))
    S = auto.setup.A
    require(isinstance(S, StreamOperator) and S.perm is not None, type(S))

    # K2 both ways against plain versions on the card: the kernel-order
    # CSR against its plain version, and the caller-order matvec/rmatvec
    # (K2 between the perm/iperm gathers) against the plain COO operator
    xr = torch.from_numpy(np.random.default_rng(13).standard_normal(
        n).astype(np.float32)).to(dev)
    xk = xr[S.perm].contiguous()
    errs = {"A_rcm": compare(S.fwd(xk), S.fwd.plain(xk), "A_rcm"),
            "A_rcm_T": compare(S.bwd(xk), S.bwd.plain(xk), "A_rcm_T"),
            "matvec": compare(S.matvec(xr), A_p.matvec(xr), "matvec"),
            "rmatvec": compare(S.rmatvec(xr), A_p.rmatvec(xr), "rmatvec")}
    # K2 sums each row in CSR order, a product then an add: bitwise
    for key, csr in (("A_rcm", S.fwd), ("A_rcm_T", S.bwd)):
        errs[key]["bitwise_csr_order"] = bool(torch.equal(
            csr(xk), csr_sequential(csr, xk[:, None])[:, 0]))
        require(errs[key]["bitwise_csr_order"], (key, errs[key]))
    # long rows (a whole block sums each) and rows of 65 to 256 (a warp
    # each): a power-law pattern, rows of 1 to 10,000 nonzeros, against the
    # plain version; its rows of at most 256 bitwise; the kernel flushed
    pl = CsrSpMV(power_law_csr(100_000, 31), device=dev)
    xp = torch.from_numpy(np.random.default_rng(37).standard_normal(
        pl.shape[1]).astype(np.float32)).to(dev)
    lens = pl.row_ptr.diff()
    yp = pl(xp)
    upto = lens <= WARP_ROW
    raw, _, _ = csr_raw(_build.load(), pl, xp)
    power_law = dict(compare(yp, pl.plain(xp), "K2 on a power-law CSR"),
                     rows=pl.shape[0], nnz=pl.nnz, **k2_fields(pl),
                     min_row=int(lens.min()), max_row=int(lens.max()),
                     bitwise_upto_warp_row=bool(torch.equal(
                         yp[upto], csr_sequential(pl, xp[:, None])[upto, 0])),
                     ms=cuda_ms_cold(raw, 20, flush))
    require(power_law["long_rows"] > 0 and power_law["max_row"] == 10_000
            and power_law["min_row"] == 1 and power_law["warp_rows"] > 0
            and power_law["bitwise_upto_warp_row"], power_law)
    del pl, xp, lens, yp, upto, raw

    b = torch.from_numpy(
        np.random.default_rng(3).standard_normal(n).astype(np.float32)
    ).to(dev)
    x = torch.zeros(n, device=dev)
    S.fwd.launches = S.bwd.launches = 0
    res = [float(torch.linalg.vector_norm(b - A_p.matvec(x)))]
    for _ in range(N_CYCLES):
        x = auto.run(b, x)
        # the plain COO A_p (index_add_) reads the residual: no K2 launch
        res.append(float(torch.linalg.vector_norm(b - A_p.matvec(x))))
    torch.cuda.synchronize()
    launches = {"A_rcm": S.fwd.launches, "A_rcm_T": S.bwd.launches}
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)
    # 3 pre + 3 post Jacobi sweeps and the residual; the cycle never
    # applies A^T
    require(launches == {"A_rcm": 7 * N_CYCLES, "A_rcm_T": 0}, launches)
    require(bool(torch.isfinite(x).all()), "stream x must be finite")
    x_plain = solve(setup_p, b, torch.zeros(n, device=dev),
                    n_cycles=N_CYCLES)
    rel = float((x - x_plain).abs().max() / x_plain.abs().max())
    require(rel <= 1e-4, rel)

    x0 = torch.zeros(n, device=dev)
    ms_cycle = cuda_ms(lambda: auto.run(b, x0), iters=20)
    SHARED.update(setup_p=setup_p, stream_ms_per_cycle=ms_cycle)
    ms_plain = cuda_ms(lambda: solve(setup_p, b, x0, n_cycles=1), iters=3,
                       warmup=1)
    prof = profile_cycles(lambda c: [auto.run(b, x0) for _ in range(c)])

    # K2's backward: a scalar of matvec and of rmatvec differentiated on
    # the card, against the plain COO operator's x-gradient and the plain
    # CSR version's values gradient (ybar[row] * x[col], autograd's)
    w = torch.from_numpy(np.random.default_rng(19).standard_normal(
        n).astype(np.float32)).to(dev)
    S.fwd.launches = S.bwd.launches = 0
    grad_errs, grad_launches = {}, {}
    for name in ("matvec", "rmatvec"):
        x1 = xr.clone().requires_grad_(True)
        x2 = xr.clone().requires_grad_(True)
        torch.sum(w * getattr(S, name)(x1)).backward()
        torch.sum(w * getattr(A_p, name)(x2)).backward()
        grad_errs[f"{name}_x_grad"] = compare(x1.grad, x2.grad,
                                             f"{name} x gradient")
        grad_launches[name] = dict(A_rcm=S.fwd.launches,
                                   A_rcm_T=S.bwd.launches)
        S.fwd.launches = S.bwd.launches = 0
    # each direction: one forward launch, one backward launch on the
    # other CSR
    require(grad_launches == {"matvec": {"A_rcm": 1, "A_rcm_T": 1},
                              "rmatvec": {"A_rcm": 1, "A_rcm_T": 1}},
            grad_launches)
    wk = w[S.perm].contiguous()
    S.fwd.vals.requires_grad_(True)
    torch.sum(wk * S.fwd(xk)).backward()
    vals_p = S.fwd.vals.detach().clone().requires_grad_(True)
    torch.sum(wk * csr_spmv_plain(entry_rows(S.fwd.row_ptr, S.nnz),
                                  S.fwd.cols, vals_p, xk, n)).backward()
    grad_errs["values_grad"] = compare(S.fwd.vals.grad, vals_p.grad,
                                       "values gradient")
    S.fwd.vals.requires_grad_(False)
    S.fwd.vals.grad = None

    lib = _build.load()
    rows_out, raws = [], {}
    for key, csr, vin, cnt in (
            ("A_rcm", S.fwd, xk, launches["A_rcm"]),
            ("A_rcm_T, backward", S.bwd, wk,
             grad_launches["matvec"]["A_rcm_T"])):
        raw, bytes_moved, flops = csr_raw(lib, csr, vin)
        raws[key] = raw
        lib_mat = csr_tensor(csr)
        lib_mat @ vin
        bound_ms, bound_by = bound(bytes_moved, flops)
        err = (errs[key] if key in errs else grad_errs["matvec_x_grad"])
        rows_out.append(dict(
            name=f"csr_spmv[{key}]", route="cuda", source=K2_ROW[1],
            replaces=K2_ROW[2], launches=cnt,
            max_abs_err=err["max_abs_err"],
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: csr.plain(vin), 5, flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms_cold(lambda: lib_mat @ vin, 20, flush),
            **k2_fields(csr)))
    emit(dict(phase="stream", setup_twogrid_s=t_setup, auto_build_s=t_auto,
              layout=auto.layout, why=auto.why, n=n, nnz=S.nnz,
              results=list(errs.values()), power_law=power_law,
              cycles=N_CYCLES,
              residual_norms=res, launches=launches,
              rel_err_vs_plain_cycle=rel, ms_per_cycle=ms_cycle,
              ms_per_cycle_plain_path=ms_plain,
              k2_raw_l2_warm_ms=cuda_ms(raws["A_rcm"], iters=50),
              device_busy_ms_per_cycle=prof["device_busy_ms_per_cycle"],
              idle_share=1.0 - prof["device_busy_ms_per_cycle"] / ms_cycle,
              top_kernels_per_cycle=prof["top_kernels_per_cycle"],
              k2_backward=dict(results=list(grad_errs.values()),
                               launches=grad_launches),
              nvidia_smi=smi))
    return rows_out, A_p, S


def jacobi_weights(dev) -> None:
    """Phase 15: the committed learned Jacobi model carried across. The
    150 test matrices regenerated from the artifact's (h, band location)
    give its diag_A; the card's learned (2/3)/D equals the port's CPU
    result and reproduces the artifact's diag_learn_Dinv (computed on a
    TPU, whose default f32 matmul rounds through bf16; JAX on a CPU
    differs from it by up to 1.5e-2)."""
    t0 = time.perf_counter()
    z = np.load(os.path.join(ARTIFACT, "test_eigenvalues.npz"))
    model = load_params_npz(os.path.join(ARTIFACT, "params.npz"),
                            TrainableJacobiMLP(device=dev))
    model_cpu = TrainableJacobiMLP(device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    diag_err, dinv, dinv_cpu = 0.0, [], []
    with torch.no_grad():
        for h, loc, want_d in zip(z["hs"], z["band_locs"], z["diag_A"]):
            K, _, _ = small_band_matrix_host(38, h, loc)
            op = SparseOperator.from_scipy(K, device="cpu")
            d = op.host_diagonal()
            diag_err = max(diag_err, float(np.max(np.abs(d - want_d)
                                                  / np.abs(want_d))))
            d32 = torch.from_numpy(d.astype(np.float32))
            nd = op.remove_diagonal()
            dinv_cpu.append(OMEGA / predict_diag(model_cpu, nd, d32)
                            .double().numpy())
            nd_dev = SparseOperator.from_scipy(K, device=dev)
            dinv.append(OMEGA / predict_diag(
                model, nd_dev.remove_diagonal(), d32.to(dev))
                .double().cpu().numpy())
    dinv, dinv_cpu = np.stack(dinv), np.stack(dinv_cpu)
    want = z["diag_learn_Dinv"]
    rel_cpu = np.abs(dinv - dinv_cpu) / np.abs(dinv_cpu)
    rel_art = np.abs(dinv - want) / np.abs(want)
    require(diag_err <= 1e-6, diag_err)
    require(bool(np.isfinite(dinv).all()) and float(rel_cpu.max()) <= 1e-5,
            float(rel_cpu.max()))
    require(float(rel_art.max()) <= 3e-2 and float(rel_art.mean()) < 1e-2,
            (float(rel_art.max()), float(rel_art.mean())))
    emit(dict(phase="jacobi_weights", matrices=int(dinv.shape[0]),
              n=int(dinv.shape[1]), diag_A_max_rel_err=diag_err,
              dinv_max_rel_err_vs_cpu=float(rel_cpu.max()),
              dinv_max_rel_err_vs_artifact=float(rel_art.max()),
              dinv_mean_rel_err_vs_artifact=float(rel_art.mean()),
              seconds=time.perf_counter() - t0))


def train_phase(dev, smi) -> None:
    """Phase 16: the trainer at the reference's widths (n_mesh 38, batch
    100, 20 probes, k = 3, MLP 5-50-20-1) on 300 matrices for 2 epochs
    (4 steps), in both loss layouts; the first step's loss on the card
    against the CPU and across layouts; ms per train step."""
    base = dict(num_matrices=300, n_mesh=38, h_low=0.0005, epochs=2,
                batch_size=100, lr=1e-2, seed=54681, n_train=200, n_val=50,
                n_test=50, m_probes=20, gelfand_k=3, widths=(50, 20, 1),
                log_every=0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ds = small_band_dataset(base["num_matrices"], n=base["n_mesh"],
                                seed=base["seed"], cache_dir=tmp, device=dev)
        out["dataset_s"] = time.perf_counter() - t0
        idx = np.arange(base["batch_size"])
        part = ds.select(idx)
        probes = _draw_probes(part, idx, base["m_probes"],
                              np.random.default_rng(0))
        first = {}
        for layout in ("dia", "stencil"):
            cfg = TrainJacobiConfig(**base, loss_layout=layout,
                                    cache_dir=tmp)
            t0 = time.perf_counter()
            _, hist = train(cfg, dataset=ds, device=dev)
            train_s = time.perf_counter() - t0
            losses = hist["train_loss"] + hist["val_loss"] + [
                hist["test_loss"]]
            require(bool(np.isfinite(losses).all()), (layout, hist))
            host = [np.asarray(a, np.float32) for a in (
                matrix_stack(part, layout), feature_stack(part),
                part.diags, probes)]
            batch = [torch.from_numpy(a).to(dev) for a in host]
            model = TrainableJacobiMLP(generator=base["seed"], device=dev)
            opt = torch.optim.Adam(model.parameters(), lr=base["lr"])
            plateau = PlateauScale(opt)
            fn = make_loss_fn(model, ds, OMEGA, 3, layout=layout)
            loss = float(train_step(model, opt, plateau, fn, batch, np.inf))
            require(all(bool(torch.isfinite(q.grad).all())
                        for q in model.parameters()), "finite gradients")
            model_cpu = TrainableJacobiMLP(generator=base["seed"],
                                           device="cpu")
            with torch.no_grad():
                loss_cpu = float(make_loss_fn(model_cpu, ds, OMEGA, 3,
                                              layout=layout)(
                    *map(torch.from_numpy, host)))
            require(abs(loss - loss_cpu) <= 1e-4 * abs(loss_cpu),
                    (layout, loss, loss_cpu))
            first[layout] = loss
            step = (lambda: train_step(model, opt, plateau, fn, batch,
                                       np.inf))
            ms = float(np.median([cuda_ms(step, iters=10, warmup=2)
                                  for _ in range(5)]))
            busy = profile_cycles(lambda c: [step() for _ in range(c)])
            out[layout] = dict(history=hist, train_s=train_s,
                               first_step_loss=loss,
                               first_step_loss_cpu=loss_cpu,
                               ms_per_step=ms,
                               device_busy_ms_per_step=busy[
                                   "device_busy_ms_per_cycle"],
                               idle_share=1.0 - busy[
                                   "device_busy_ms_per_cycle"] / ms,
                               top_kernels_per_step=busy[
                                   "top_kernels_per_cycle"][:6])
    require(abs(first["dia"] - first["stencil"])
            <= 1e-4 * abs(first["dia"]), first)
    emit(dict(phase="train", tf32=False, **out, nvidia_smi=smi))


def stream_training(A_p, flush, smi) -> list:
    """Phases 13-14 (kernel K3 on the stream phase's operator): K3 on A and
    A^T against its plain version at M = 20 with its times, and the
    unstructured training flow of the JAX package's tests at full size;
    returns K3's rows of the kernels line."""
    dev, n, m = A_p.device, A_p.n_rows, M_PROBES
    csr = A_p.to_scipy()
    csr.sort_indices()
    B, perm = rcm_csr(csr)  # the stream phase's kernel order
    mm, mt = csr_pair(B, dev, width=n)
    X = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (n, m)).astype(np.float32)).to(dev)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    errs, lib_errs, timing = {}, {}, {}
    bitwise = {}
    for key, op in (("A", mm), ("At", mt)):
        y = op(X)
        errs[key] = compare(y, op.plain(X), f"K3 on {key}")
        # the redesigned kernel keeps each output's arithmetic: a CSR-order
        # sequential sum, product by product
        bitwise[key] = bool(torch.equal(y, csr_sequential(op, X)))
        require(bitwise[key], f"K3 on {key} is not the CSR-order sum")
        # the library yardstick: one torch.sparse.mm (cuSPARSE SpMM) on
        # the same CSR
        lib_mat = csr_tensor(op)
        lib_fn = (lambda lib_mat=lib_mat: torch.sparse.mm(lib_mat, X))
        lib_errs[key] = compare(lib_fn(), y,
                                f"torch.sparse.mm yardstick of K3 on {key}")
        out = torch.empty_like(X)

        def raw(op=op, out=out):
            _build.check(lib.csr_spmm_f32(
                op.row_ptr.data_ptr(), op.cols.data_ptr(),
                op.vals.data_ptr(), n, m, X.data_ptr(), out.data_ptr(),
                stream), "K3 raw")
        timing[key] = dict(
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda op=op: op.plain(X), 5, flush),
            library_ms=cuda_ms_cold(lib_fn, 20, flush),
            **warm_and_device_ms(raw))
    # the scalar variant: M not a multiple of 4 (M = 7), and X at an
    # address that is not 16-byte aligned (M = 20)
    X7 = X[:, :7].contiguous()
    buf = torch.empty(n * m + 1, device=dev)
    X_off = buf[1:].view(n, m)
    X_off.copy_(X)
    require(X_off.data_ptr() % 16 != 0, "X_off must be misaligned")
    scalar = {}
    for key, xin in (("M7", X7), ("misaligned", X_off)):
        y = mm(xin)
        scalar[key] = dict(compare(y, mm.plain(xin), f"K3 {key}"),
                           bitwise_csr_order=bool(torch.equal(
                               y, csr_sequential(mm, xin))))
        require(scalar[key]["bitwise_csr_order"], (key, scalar[key]))
    require(torch.equal(mm(X_off), mm(X)), "misaligned X changed K3's sums")
    del buf, X_off, X7
    # each input read once, the output written once: the CSR, X, Y
    bytes_moved = mm.nnz * 8 + (n + 1) * 4 + 2 * n * m * 4
    bound_ms, bound_by = bound(bytes_moved, 2 * mm.nnz * m)
    emit(dict(phase="spmm", n=n, nnz=mm.nnz, m=m,
              results=list(errs.values()), bitwise_csr_order=bitwise,
              scalar_variant=scalar, library_vs_kernel=lib_errs,
              bytes=bytes_moved, bound_ms=bound_ms, bound_by=bound_by,
              times=timing, nvidia_smi=smi))

    # ------------------------------------------------- train_stream
    # the same operator negated (a positive diagonal, like the FEM
    # matrices): the Gelfand loss on K3 against the plain COO path
    rows, cols, vals = A_p.host_coo()
    A_n = SparseOperator.from_coo(rows, cols, -vals, A_p.shape, device=dev)
    B_n = (-B).tocsr()
    B_n.sort_indices()
    mm_n, mt_n = csr_pair(B_n, dev, width=n)
    p = torch.from_numpy(perm.astype(np.int64)).to(dev)
    probes = torch.from_numpy(uniform_probes(
        n, m, np.random.default_rng(29)).astype(np.float32)).to(dev)
    probes_k = probes[p].contiguous()

    def loss_spmm(d):
        return damping_factor_gelfand_spmm(mm_n, d[p], OMEGA, probes_k, k=3)

    def loss_coo(d):
        return damping_factor_gelfand(A_n, d, OMEGA, probes, k=3)

    d0 = A_n.diagonal()
    mm_n.launches_mm = mt_n.launches_mm = 0
    d = d0.clone().requires_grad_(True)
    l_s = loss_spmm(d)
    g_s, = torch.autograd.grad(l_s, d)
    l_s = float(l_s)
    torch.cuda.synchronize()
    launches = {"A": mm_n.launches_mm, "At": mt_n.launches_mm}
    require(launches == {"A": 3, "At": 2}, launches)
    d2 = d0.clone().requires_grad_(True)
    l_c = loss_coo(d2)
    g_c, = torch.autograd.grad(l_c, d2)
    l_c = float(l_c)
    require(abs(l_s - l_c) <= 1e-4 * abs(l_c), (l_s, l_c))
    g_err = compare(g_s, g_c, "Gelfand gradient in the diagonal", 1e-3,
                    1e-5)
    # four plain gradient steps lower the loss. The JAX package's test
    # steps 0.5 g at 4,000 rows; the gradient of the max-norm loss falls
    # as 1/n per entry, and at n = 2^20 a step of 0.5 g moves the loss by
    # less than one f32 ulp (the four losses are bit-identical), so the
    # step grows with n: 0.5 n / 4096 (128 here, moving d by < 1e-3)
    lr_d = 0.5 * n / 4096
    dd, losses = d0.clone(), []
    for _ in range(4):
        dd.requires_grad_(True)
        lo = loss_spmm(dd)
        g, = torch.autograd.grad(lo, dd)
        losses.append(float(lo.detach()))
        dd = (dd - lr_d * g).detach()
    require(all(b < a for a, b in zip(losses, losses[1:])), losses)

    # the learned-D composition: features -> MLP (the committed weights)
    # -> the SpMM loss -> backward -> Adam
    model = load_params_npz(os.path.join(ARTIFACT, "params.npz"),
                            TrainableJacobiMLP(device=dev))
    nd, diag = A_n.remove_diagonal(), A_n.diagonal()
    grads = {}
    for name, lf in (("spmm", loss_spmm), ("coo", loss_coo)):
        model.zero_grad(set_to_none=True)
        lo = lf(model(jacobi_diag_features(nd, diag)).reshape(-1))
        lo.backward()
        grads[name] = (float(lo.detach()), [q.grad.clone() for q in
                                   model.parameters()])
    require(all(np.isfinite(grads[k][0]) for k in grads), grads)
    mlp_errs = [compare(a, b, f"MLP gradient {i}", 1e-3, 1e-5)
                for i, (a, b) in enumerate(zip(grads["spmm"][1],
                                               grads["coo"][1]))]
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        lo = loss_spmm(model(jacobi_diag_features(nd, diag)).reshape(-1))
        lo.backward()
        opt.step()
        return lo

    ms_step = float(np.median([cuda_ms(step, iters=5, warmup=1)
                               for _ in range(3)]))
    busy = profile_cycles(lambda c: [step() for _ in range(c)])
    emit(dict(phase="train_stream", n=n, m=m, k=3,
              loss_spmm=l_s, loss_coo=l_c,
              grad_vs_coo=g_err, launches_per_value_and_grad=launches,
              diagonal_step=lr_d, diagonal_step_losses=losses,
              learned_d_loss=grads["spmm"][0],
              learned_d_loss_coo=grads["coo"][0],
              mlp_grad_vs_coo=mlp_errs, ms_per_step=ms_step,
              device_busy_ms_per_step=busy["device_busy_ms_per_cycle"],
              idle_share=1.0 - busy["device_busy_ms_per_cycle"] / ms_step,
              top_kernels_per_step=busy["top_kernels_per_cycle"][:8],
              nvidia_smi=smi))
    return [dict(name=f"csr_spmm[{key}]", route="cuda",
                 source="gnnla_tpu_torch/csrc/csr_spmm.cu",
                 replaces="gnnla_tpu/ops/pallas_stream.py:635",
                 launches=launches[key], max_abs_err=errs[key]["max_abs_err"],
                 ms=timing[key]["ms"], plain_ms=timing[key]["plain_ms"],
                 bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=timing[key]["library_ms"])
            for key in ("A", "At")]


def warm_and_device_ms(raw) -> dict:
    """A raw launch back to back, L2 warm (median of 5 windows of 20),
    and the profiler's device time per kernel launch, which no host delay
    can inflate: its device time over the launches it recorded, since it
    can drop some of a window's (the count it kept per call is beside)."""
    top = profile_cycles(lambda c: [raw() for _ in range(c)])[
        "top_kernels_per_cycle"]
    kept = sum(t["launches"] for t in top)
    return dict(warm_ms=float(np.median([cuda_ms(raw, iters=20)
                                         for _ in range(5)])),
                device_ms_per_launch=(sum(t["ms"] for t in top) / kept
                                      if kept else None),
                profiler_launches_per_call=kept)


def kernel_grads(A, plain, fast, flush, smi) -> list:
    """Phases 17-19 (K1's backward and bf16 storage, K4's backward) on the
    1024^2 Laplacian and the fast setup's Ac; returns the rows of the
    backward launches and the bf16 kernel."""
    dev, lib = A.device, _build.load()
    gen = np.random.default_rng(17)

    def rand(n):
        return torch.from_numpy(gen.standard_normal(n).astype(
            np.float32)).to(dev)

    rows_out = []
    A_t = A.transpose()  # the CSR of A^T: the x cotangents' yardstick

    # ---------------------------------------------------------- dia_grad
    grad_out = {}
    for key in ("A", "Ac"):
        op = getattr(fast, key)
        x, w = rand(op.n), rand(op.n)
        op.launches = 0
        op.diags.requires_grad_(True)
        x1 = x.clone().requires_grad_(True)
        y = op.matvec(x1)
        fwd = op.launches
        torch.dot(w, y).backward()
        torch.cuda.synchronize()
        launches = dict(forward=fwd, backward=op.launches - fwd)
        require(launches == dict(forward=1, backward=1), (key, launches))
        gx, gd = x1.grad, op.diags.grad
        op.diags.requires_grad_(False)
        op.diags.grad = None
        # the plain twin's autograd on the same inputs
        d2 = op.diags.detach().clone().requires_grad_(True)
        x2 = x.clone().requires_grad_(True)
        torch.dot(w, dia_matvec(d2, op.offsets, x2)).backward()
        errs = dict(x_grad=compare(gx, x2.grad, f"{key}: x gradient"),
                    diags_grad=compare(gd, d2.grad,
                                       f"{key}: diagonals gradient"))
        del gd, d2, x2
        tiles_t = op.tiles_t
        raw, bytes_moved, flops = dia_raw(lib, tiles_t, w)
        lib_mat = csr_tensor(A_t if key == "A" else plain.Ac.transpose())
        # the plain version on A^T's dense diagonals, built here only
        t = dia_transpose(op.plain())
        errs["library"] = compare(lib_mat @ w, gx,
                                  f"cuSPARSE A^T w yardstick of {key}")
        bound_ms, bound_by = bound(bytes_moved, flops)
        rows_out.append(dict(
            name=f"dia_spmv[{key}t]", route="cuda", source=K1_ROW[0],
            replaces=K1_ROW[1], launches=launches["backward"],
            max_abs_err=errs["x_grad"]["max_abs_err"],
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: dia_matvec(t.diags, t.offsets, w),
                                  5, flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms_cold(lambda: lib_mat @ w, 20, flush),
            **k1_fields(tiles_t, len(t.offsets), op.nnz)))
        grad_out[key] = dict(K=len(op.offsets), K_transposed=len(t.offsets),
                             launches=launches, rebuilds=op.rebuilds,
                             results=errs, **warm_and_device_ms(raw))
        require(op.rebuilds == 0, (key, "rebuilt by forward and backward"))
        del lib_mat, t
    emit(dict(phase="dia_grad", rtol=RTOL, atol=f"{RTOL} * max|g|",
              **grad_out, nvidia_smi=smi))

    # ---------------------------------------------------------- dia_bf16
    bf_out = {}
    for key in ("A", "Ac"):
        op32 = getattr(fast, key)
        op16 = dia_kernel_operator(op32.plain(), diag_dtype=torch.bfloat16)
        x = rand(op32.n)
        y16 = op16.matvec(x)
        launches = op16.launches
        y_plain = op16.plain().matvec(x)  # bf16-stored diagonals upcast
        err = compare(y16, y_plain, f"bf16 K1 on {key}")
        bitwise = bool(torch.equal(y16, op32.matvec(x)))
        if key == "A":  # -4 and 1 are exact in bf16
            require(bitwise, "bf16 K1 on A must equal the f32 kernel")
        raw, bytes_moved, flops = dia_raw(lib, op16.tiles, x)
        lib_mat = csr_tensor(getattr(plain, key))
        bound_ms, bound_by = bound(bytes_moved, flops)
        rows_out.append(dict(
            name=f"dia_spmv_bf16[{key}]", route="cuda", source=K1_ROW[0],
            replaces=K1_ROW[1], launches=launches,
            max_abs_err=err["max_abs_err"], ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: op16.plain().matvec(x), 5, flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms_cold(lambda: lib_mat @ x, 20, flush),
            **k1_fields(op16.tiles, len(op16.offsets), op16.nnz)))
        bf_out[key] = dict(K=len(op16.offsets), result=err,
                           bitwise_equal_to_f32_kernel=bitwise,
                           max_rel_err_vs_f32_kernel=float(
                               (y16 - op32.matvec(x)).abs().max()
                               / op32.matvec(x).abs().max()),
                           **warm_and_device_ms(raw))
        del op16, lib_mat
    emit(dict(phase="dia_bf16", **bf_out, nvidia_smi=smi))

    # ------------------------------------------------------ stencil_grad
    gs = (N_GRID, N_GRID)
    st_out, st_rows = {}, []
    stream = torch.cuda.current_stream().cuda_stream
    for n_steps in (1, 3):
        sp_ = make_stencil_spmv(A, gs, n_steps)
        x, w = rand(A.n_rows).reshape(gs), rand(A.n_rows).reshape(gs)
        sp_.taps.requires_grad_(True)
        x1 = x.clone().requires_grad_(True)
        sp_._call.launches = sp_.launches_t = 0
        torch.sum(w * sp_.apply(x1)).backward()
        torch.cuda.synchronize()
        launches = dict(forward=sp_._call.launches,
                        x_cotangent=sp_.launches_t)
        # one launch each way: per step at one step, the tile form at 3
        require(sp_._call.form.form == sp_.form_t.form == (
            "tile" if n_steps > 1 else "step"), (sp_._call.form, sp_.form_t))
        require(launches == dict(forward=1, x_cotangent=1),
                (n_steps, launches))
        gx, gt = x1.grad, sp_.taps.grad
        sp_.taps.requires_grad_(False)
        t2 = sp_.taps.detach().clone().requires_grad_(True)
        x2 = x.clone().requires_grad_(True)
        y2 = x2
        for _ in range(n_steps):
            y2 = stencil_matvec(t2, sp_.shifts, y2)
        torch.sum(w * y2).backward()
        errs = dict(x_grad=compare(gx, x2.grad, f"{n_steps} steps: x grad"),
                    taps_grad=compare(gt, t2.grad,
                                      f"{n_steps} steps: taps grad"))
        # x's cotangent alone: K4 on the transposed taps
        _, planes_t = stencil_transpose(sp_.shifts, sp_.taps.float())
        planes_t = planes_t.contiguous()
        bufs = stencil_buffers(w, n_steps, "plain", sp_.form_t)
        args = stencil_args(planes_t, sp_._shifts_t_host, w, n_steps,
                            "plain", None, *bufs, sp_.form_t)

        def raw(args=args):
            _build.check(lib.stencil_f32(*args, stream), "K4 raw")
        k = planes_t.shape[0]
        bound_ms, bound_by = bound((k * 4 + 8) * A.n_rows,
                                   n_steps * A.n_rows * 2 * k)
        library_ms = None
        if n_steps == 1:
            lib_mat = csr_tensor(A_t)
            wf = w.reshape(-1)
            errs["library"] = compare(lib_mat @ wf, gx.reshape(-1),
                                      "cuSPARSE A^T w yardstick")
            library_ms = cuda_ms_cold(lambda: lib_mat @ wf, 20, flush)
        ms = cuda_ms_cold(raw, 20, flush)
        plain_ms = cuda_ms_cold(lambda: stencil_apply_plain(
            planes_t, sp_.shifts_t, w, n_steps, "plain"), 5, flush)
        st_out[f"n_steps_{n_steps}"] = dict(
            launches=launches, results=errs, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, library_ms=library_ms,
            **warm_and_device_ms(raw))
        st_rows.append(dict(max_abs_err=errs["x_grad"]["max_abs_err"],
                            launches=launches["x_cotangent"], ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms,
                            form=sp_.form_t))
    emit(dict(phase="stencil_grad", K=len(sp_.shifts), **st_out,
              nvidia_smi=smi))
    one = st_rows[0]  # the row is the one-step call; launches: both runs
    rows_out.append(dict(
        name="stencil[plain,T]", route="cuda", source=K4_ROW[0],
        replaces=K4_ROW[1], launches=sum(r["launches"] for r in st_rows),
        **{k: one[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")},
        form=one["form"].form, tile=one["form"].tile, halo=one["form"].halo,
        vec=one["form"].vec))
    return rows_out


def dia_nonfinite(fast, on_k1, smi) -> None:
    """K1 on x with +inf, -inf and NaN at columns that some rows reach
    only through a skipped segment: the fast setup's A and Ac, the first
    SA level on the split form, Ac with bf16 diagonals, and the transposed
    layouts of A and Ac (x's cotangent). NaN and inf positions must equal
    the plain version's, the finite entries agree within rtol, no layout
    is rebuilt and each layout's state is left zeroed."""
    split_lvl = min(lvl for lvl, a in on_k1.items() if a.tiles.split)
    ac16 = dia_kernel_operator(fast.Ac.plain(), diag_dtype=torch.bfloat16)
    cases = {  # name -> (operator, its layout, transposed?)
        "A": (fast.A, fast.A.tiles, False),
        "Ac": (fast.Ac, fast.Ac.tiles, False),
        f"SA{split_lvl}_split": (on_k1[split_lvl], on_k1[split_lvl].tiles,
                                 False),
        "Ac_bf16": (ac16, ac16.tiles, False),
        "At": (fast.A, fast.A.tiles_t, True),
        "Act": (fast.Ac, fast.Ac.tiles_t, True),
    }
    out = {}
    for seed, (name, (op, tiles, transposed)) in enumerate(cases.items()):
        cols, rows = nonfinite_probe(tiles, 3, seed)
        # the Laplacian's layouts skip segments only past its first and
        # last grid rows: no column hides there, and they take no ticket
        require(bool(cols) == (name not in ("A", "At")) == tiles.repair,
                (name, cols, tiles.repair))
        gen = np.random.default_rng(100 + seed)
        x = torch.from_numpy(gen.standard_normal(op.n).astype(
            np.float32)).to(tiles.seg_ptr.device)
        if not cols:
            cols = gen.choice(op.n, 3, replace=False).tolist()
        x[cols] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                               device=x.device)
        rebuilds, launches = op.rebuilds, op.launches
        got = op.launch_t(x) if transposed else op.matvec(x)
        plain = dia_transpose(op.plain()) if transposed else op.plain()
        want = plain.matvec(x)
        del plain
        torch.cuda.synchronize()
        masks = {test.__name__: bool(torch.equal(test(got), test(want)))
                 for test in (torch.isnan, torch.isposinf, torch.isneginf)}
        fin = torch.isfinite(want)
        entry = dict(K=len(op.offsets), split_form=tiles.split,
                     repair=tiles.repair,
                     diag_dtype=str(tiles.seg_vals.dtype),
                     hidden_rows=len(rows), masks_equal=masks,
                     nan_rows=int(torch.isnan(want).sum()),
                     inf_rows=int(torch.isinf(want).sum()),
                     finite=compare(got[fin], want[fin], f"{name} finite"),
                     launches=op.launches - launches,
                     rebuilds=op.rebuilds - rebuilds,
                     state=tiles.state.tolist())
        require(all(masks.values()) and entry["launches"] == 1
                and entry["rebuilds"] == 0 and entry["state"] == [0, 0]
                and bool(torch.isnan(want[rows]).all()), (name, entry))
        out[name] = entry
    del ac16
    emit(dict(phase="dia_nonfinite", rtol=RTOL, **out, nvidia_smi=smi))


def jax_bench_reference() -> dict:
    """The JAX package's bench numbers on the same problems
    (BENCH_r05.json, whose last line is kept as a text tail): the SA-PCG
    iteration count and the convergence factors."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    return {k: float(v) for k, v in re.findall(
        r'"(convfac_\w+|pcg_iters_to_1e8)": ([0-9.]+)', tail)}


def coarsest_chebyshev(op, sa, gen) -> Optional[dict]:
    """The SA hierarchy's coarsest solve (degree-8 Chebyshev on its (c,
    d)) where that level is on K1: K1's one-launch form against the eager
    chain on the same operator (8 K1 launches and the vector updates
    between them, through an object with the operator's matvec alone):
    bitwise, the launches of each, ms a call by CUDA events over 200
    calls back to back and device-busy ms a call from the profiler.
    None where the coarsest is not on K1."""
    if op is None:
        return None
    bc = torch.from_numpy(gen.standard_normal(op.n).astype(
        np.float32)).to(op.device)
    xc = torch.zeros_like(bc)
    cheb = dict(c=sa.coarse_c, d=sa.coarse_d, deg=8)
    chain_op = types.SimpleNamespace(matvec=op.matvec)
    require(op.takes_chebyshev(bc, xc, 8), "the coarsest takes no form")
    out = {}
    for name, target in (("form", op), ("chain", chain_op)):
        before = op.launches
        y = chebyshev(target, bc, xc, **cheb)
        torch.cuda.synchronize()
        out[name] = dict(
            launches=op.launches - before,
            ms=cuda_ms(lambda: chebyshev(target, bc, xc, **cheb), 200),
            device_ms=profile_cycles(lambda c: [
                chebyshev(target, bc, xc, **cheb) for _ in range(c)])[
                    "device_busy_ms_per_cycle"])
        out[name + "_x"] = y
    bitwise = bool(torch.equal(out.pop("form_x"), out.pop("chain_x")))
    require(bitwise and out["form"]["launches"] == 1
            and out["chain"]["launches"] == 8, out)
    return dict(rows=op.n, segments=op.tiles.n_segs,
                bitwise_eager_chain=bitwise, **out)


def multigrid_phases(A, plain, fast, b, flush, smi) -> list:
    """Phases 20-22: the SA hierarchy and mg_pcg at 1024^2, amg_pcg on the
    fast setup, and the convergence-factor table; returns the rows of K1
    on each SA level it runs on."""
    dev, n = A.device, A.n_rows
    lib = _build.load()
    ref = jax_bench_reference()
    x0 = torch.zeros(n, device=dev)
    bnorm = float(torch.linalg.vector_norm(b))

    # --------------------------------------------------------- multigrid
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sa = setup_sa_multigrid(A, seed=0)
    t_sa = time.perf_counter() - t0
    t0 = time.perf_counter()
    mg = setup_with_dia_multigrid(sa, kernel=True)
    t_dia = time.perf_counter() - t0
    hierarchy_bytes = torch.cuda.memory_allocated() - base
    L = mg.n_levels
    require(isinstance(mg.As[0], DiaKernelOperator), type(mg.As[0]))
    on_k1 = {lvl: a for lvl, a in enumerate(mg.As)
             if isinstance(a, DiaKernelOperator)}
    cycles = PCG_ITERS + 1  # CG preconditions its first residual too

    def want_launches(lvl):
        """K1 launches of one mg_pcg at a K1 level: per cycle n_pre +
        residual + n_post (1 + 1 + 1), at the coarsest one (its degree-8
        Chebyshev in K1's one-launch form), and CG's own matvec on A_0."""
        if lvl == L - 1:
            return cycles
        return (3 + (lvl == 0)) * cycles

    for a in on_k1.values():
        a.launches = 0
    require(all(isinstance(p, RectStreamOperator) for p in mg.Ps),
            [type(p) for p in mg.Ps])
    for p in mg.Ps:
        p.fwd.launches = p.bwd.launches = 0
    x, hist = mg_pcg(mg, b, x0, n_iters=PCG_ITERS, flip_sign=True)
    torch.cuda.synchronize()
    got = {lvl: a.launches for lvl, a in on_k1.items()}
    want = {lvl: want_launches(lvl) for lvl in on_k1}
    require(got == want, (got, want))
    p_launches = [(p.fwd.launches, p.bwd.launches) for p in mg.Ps]
    require(p_launches == [(cycles, cycles)] * (L - 1), p_launches)
    rel_hist = hist.cpu().numpy() / bnorm
    conv = np.flatnonzero(rel_hist < 1e-8)
    require(conv.size > 0, f"no 1e-8 in {PCG_ITERS} iterations: {rel_hist}")
    iters = int(conv[0]) + 1
    require(abs(iters - ref["pcg_iters_to_1e8"]) <= 1,
            (iters, ref["pcg_iters_to_1e8"]))
    require(bool(torch.isfinite(x).all()), "mg_pcg x must be finite")
    true_rel = float(torch.linalg.vector_norm(b - A.matvec(x))) / bnorm
    # the same hierarchy on plain DIA levels (K1's plain twin)
    x_pl, _ = mg_pcg(setup_with_dia_multigrid(sa), b, x0,
                     n_iters=PCG_ITERS, flip_sign=True)
    rel = float((x - x_pl).abs().max() / x_pl.abs().max())
    require(rel <= 1e-4, rel)
    del x_pl
    b_s = np.random.default_rng(5).standard_normal(64 * 64).astype(
        np.float32)

    def small(device):
        A_s = laplacian_2d(64, device=device).eliminate_zeros()
        m = setup_with_dia_multigrid(setup_sa_multigrid(A_s, seed=0),
                                     kernel=True)
        bb = torch.from_numpy(b_s).to(device)
        return mg_pcg(m, bb, torch.zeros_like(bb), n_iters=10,
                      flip_sign=True)[0].cpu()

    x_s, x_h = small(dev), small("cpu")
    rel_small = float((x_s - x_h).abs().max() / x_h.abs().max())
    require(rel_small <= 2e-5, rel_small)

    def solve_once():
        return mg_pcg(mg, b, x0, n_iters=PCG_ITERS, flip_sign=True)

    ms_iter = float(np.median([cuda_ms(solve_once, iters=1, warmup=1)
                               for _ in range(5)])) / PCG_ITERS
    busy = profile_cycles(lambda c: [solve_once() for _ in range(c)])
    busy_iter = busy["device_busy_ms_per_cycle"] / PCG_ITERS
    SHARED.update(sa=sa, mg=mg, mg_pcg_ms_per_iter=ms_iter)
    peak = torch.cuda.max_memory_allocated()
    rebuilds = {lvl: a.rebuilds for lvl, a in on_k1.items()}
    require(not any(rebuilds.values()), ("K1 layouts rebuilt", rebuilds))
    levels, rows_out = [], []
    gen = np.random.default_rng(19)
    for lvl, a0 in enumerate(sa.As):
        entry = dict(level=lvl, rows=a0.n_rows, nnz=a0.nnz,
                     on_k1=lvl in on_k1,
                     P_nnz=sa.Ps[lvl].nnz if lvl < L - 1 else None)
        if lvl in on_k1:
            op = on_k1[lvl]
            xin = torch.from_numpy(gen.standard_normal(op.n).astype(
                np.float32)).to(dev)
            err = compare(op.matvec(xin), op.plain().matvec(xin),
                          f"K1 on SA level {lvl}")
            lib_mat = csr_tensor(a0)
            lib_err = compare(lib_mat @ xin, op.matvec(xin),
                              f"cuSPARSE yardstick of SA level {lvl}")
            raw, bytes_moved, flops = dia_raw(lib, op.tiles, xin)
            bound_ms, bound_by = bound(bytes_moved, flops)
            row = dict(
                name=f"dia_spmv[SA{lvl}]", route="cuda", source=K1_ROW[0],
                replaces=K1_ROW[1], launches=got[lvl],
                max_abs_err=err["max_abs_err"],
                ms=cuda_ms_cold(raw, 10, flush),
                plain_ms=cuda_ms_cold(lambda: op.plain().matvec(xin), 5,
                                      flush),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms_cold(lambda: lib_mat @ xin, 10, flush),
                **k1_fields(op.tiles, len(op.offsets), op.nnz))
            rows_out.append(row)
            entry.update(K=len(op.offsets), diag_bytes=op.diags.numel() * 4,
                         k1_launches=got[lvl], k1_ms=row["ms"],
                         result=err, library_vs_kernel=lib_err,
                         **{k: row[k] for k in (
                             "plain_ms", "library_ms", "bound_ms",
                             "dense_bound_ms", "nnz_floor_ms", "segments",
                             "stored_bytes", "split_form")})
            del lib_mat
        levels.append(entry)

    # the classical hierarchy (pmis, signed interpolation, truncation)
    t0 = time.perf_counter()
    cl = setup_multigrid(A)
    t_cl = time.perf_counter() - t0
    cl = setup_with_dia_multigrid(cl, kernel=True)
    xc = torch.zeros(n, device=dev)
    res_cl = [bnorm]
    for _ in range(3):
        xc = multigrid_cycle(cl, b, xc)
        res_cl.append(float(torch.linalg.vector_norm(b - A.matvec(xc))))
    require(all(r1 < r0 for r0, r1 in zip(res_cl, res_cl[1:])), res_cl)
    emit(dict(phase="multigrid", n=n, levels=levels, n_levels=L,
              levels_on_k1=sorted(on_k1), sa_setup_s=t_sa,
              dia_swap_s=t_dia, coarse_c=sa.coarse_c, coarse_d=sa.coarse_d,
              pcg_iters=PCG_ITERS, rel_residual_history=rel_hist.tolist(),
              iters_to_1e8=iters, jax_iters_to_1e8=ref["pcg_iters_to_1e8"],
              true_rel_residual=true_rel, k1_launches=got,
              k2_p_launches=p_launches,
              k1_rebuilds=rebuilds,
              rel_err_vs_plain_dia_levels=rel, rel_err_64sq_vs_cpu=rel_small,
              ms_per_iter=ms_iter, ms_to_1e8=ms_iter * iters,
              device_busy_ms_per_iter=busy_iter,
              idle_share=1.0 - busy_iter / ms_iter,
              top_kernels_per_solve=busy["top_kernels_per_cycle"][:8],
              hierarchy_bytes=hierarchy_bytes, peak_mem_bytes=peak,
              peak_mem_bytes_above_earlier_phases=peak - base,
              classical=dict(setup_s=t_cl, n_levels=cl.n_levels,
                             rows=[a.n_rows for a in cl.As],
                             on_k1=[isinstance(a, DiaKernelOperator)
                                    for a in cl.As],
                             residual_norms=res_cl),
              nvidia_smi=smi))

    dia_nonfinite(fast, on_k1, smi)

    # --------------------------------------------------------------- pcg
    counted = dict(A=fast.A, Ac=fast.Ac, P=fast.P.fwd, Pt=fast.P.bwd)
    for op in counted.values():
        op.launches = 0
    x, hist = amg_pcg(fast, b, x0, n_iters=10, flip_sign=True)
    torch.cuda.synchronize()
    launches = {k: op.launches for k, op in counted.items()}
    require(fast.A.rebuilds == fast.Ac.rebuilds == 0,
            "a K1 layout was rebuilt inside amg_pcg")
    c = 10 + 1
    # per cycle: A 1 + 1 + 1 (n_smooth 1), Ac the Chebyshev's degree 4,
    # P and P^T once; CG's matvec adds one A per iteration
    want_pcg = dict(A=4 * c, Ac=4 * c, P=c, Pt=c)
    require(launches == want_pcg, (launches, want_pcg))
    _, hist_cg = cg(lambda v: -fast.A.matvec(v), -b, x0, n_iters=10)
    h, h_cg = hist.cpu().numpy() / bnorm, hist_cg.cpu().numpy() / bnorm
    require(h[-1] < h_cg[-1], (h.tolist(), h_cg.tolist()))
    x_pl, _ = amg_pcg(plain, b, x0, n_iters=10, flip_sign=True)
    rel_pcg = float((x - x_pl).abs().max() / x_pl.abs().max())
    require(rel_pcg <= 1e-4, rel_pcg)
    ms_pcg = float(np.median([cuda_ms(lambda: amg_pcg(
        fast, b, x0, n_iters=10, flip_sign=True), iters=1, warmup=1)
        for _ in range(5)])) / 10
    busy_pcg = profile_cycles(lambda c: [amg_pcg(
        fast, b, x0, n_iters=10, flip_sign=True) for _ in range(c)])[
            "device_busy_ms_per_cycle"] / 10
    emit(dict(phase="pcg", rel_residual_history=h.tolist(),
              cg_rel_residual_history=h_cg.tolist(), launches=launches,
              rel_err_vs_plain_setup=rel_pcg, ms_per_iter=ms_pcg,
              device_busy_ms_per_iter=busy_pcg,
              idle_share=1.0 - busy_pcg / ms_pcg,
              nvidia_smi=smi))

    # ------------------------------------------------------- convergence
    table = {}
    for size in CONV_SIZES:
        op = laplacian_2d(size, device=dev).eliminate_zeros()
        bb = torch.ones(op.n_rows, device=dev)
        r0 = float(torch.linalg.vector_norm(bb))
        tg = setup_with_stream_p(setup_with_dia(
            setup_twogrid(op, splitting="cljp", seed=0), kernel=True))
        xk = solve(tg, bb, torch.zeros_like(bb), n_cycles=8)
        cf_cl = (float(torch.linalg.vector_norm(bb - op.matvec(xk)))
                 / r0) ** (1 / 8)
        sa_s = setup_with_dia_multigrid(setup_sa_multigrid(op, seed=0),
                                        kernel=True)
        xs = torch.zeros_like(bb)
        for _ in range(8):
            xs = multigrid_cycle(sa_s, bb, xs, n_pre=2, n_post=2)
        cf_sa = (float(torch.linalg.vector_norm(bb - op.matvec(xs)))
                 / r0) ** (1 / 8)
        jax_cl = ref[f"convfac_classical_{size}"]
        jax_sa = ref[f"convfac_sa_{size}"]
        require(cf_sa < cf_cl, (size, cf_sa, cf_cl))
        require(abs(cf_cl - jax_cl) <= 0.01 and abs(cf_sa - jax_sa) <= 0.01,
                (size, cf_cl, jax_cl, cf_sa, jax_sa))
        table[size] = dict(classical=cf_cl, sa=cf_sa, jax_classical=jax_cl,
                           jax_sa=jax_sa, sa_levels=sa_s.n_levels,
                           sa_levels_on_k1=[isinstance(a, DiaKernelOperator)
                                            for a in sa_s.As])
    emit(dict(phase="convergence", cycles=8, table=table))
    return rows_out


# the operators of the solve cells' SA hierarchies that run on K2, keyed
# "A<l>" (a level `to_dia` refused), "P<l>" and "P<l>T"
SA_K2_SHAPES = (("3d", (128, 128, 128), ("A1", "A2", "A3", "P0", "P0T",
                                          "P1T", "P2T")),
                ("2d", (2048, 2048), ("P0", "P0T")))


def sa_k2_phase(lib, flush, smi) -> list:
    """Phase 22b: K2 at the shapes the benchmark's solve cells run on it —
    the SA hierarchies (theta 0.08, seed 0) of the 128^3 and 2048^2 FD
    Laplacians through `setup_with_dia_multigrid(kernel=True)`: no COO
    operator left, each twin's launches in one V(1,1) cycle (3 on a K2
    level, 8 at a K2 coarsest, 1 + 1 on each P), and per shape of
    SA_K2_SHAPES the kernel against its plain version, its flushed time,
    the bound, the plain version's, the COO operator's it replaced and
    cuSPARSE's (a `csr_spmv[SA<grid>.<key>]` row each), with the share of
    rows and of nonzeros in rows a whole CUDA block sums; K1's fused forms
    bitwise on every K1 smoothing level (`sa_fused_bitwise`) and timed on
    2-D levels 0 and 1 (`sa_fused_rows`); the coarsest's Chebyshev in
    K1's one-launch form against the eager chain (`coarsest_chebyshev`)."""
    dev = torch.device("cuda")
    rows_out, summary = [], {}
    for tag, grid, keys in SA_K2_SHAPES:
        A = laplacian_nd(grid, device=dev)[0]
        sa = setup_sa_multigrid(A, theta=0.08, seed=0)
        t0 = time.perf_counter()
        mg = setup_with_dia_multigrid(sa, kernel=True)
        t_swap = time.perf_counter() - t0
        require(not any(isinstance(op, SparseOperator)
                        for op in mg.As + mg.Ps), (tag, "COO left"))
        twins = {}  # key -> (CsrSpMV, the COO apply it replaced, per cycle)
        last = mg.n_levels - 1
        for lvl, (a, a0) in enumerate(zip(mg.As, sa.As)):
            if isinstance(a, StreamOperator):
                twins[f"A{lvl}"] = (a.fwd, a0.matvec, 8 if lvl == last else 3)
        for lvl, (p, p0) in enumerate(zip(mg.Ps, sa.Ps)):
            twins[f"P{lvl}"] = (p.fwd, p0.matvec, 1)
            twins[f"P{lvl}T"] = (p.bwd, p0.rmatvec, 1)
        for csr, _, _ in twins.values():
            csr.launches = 0
        on_k1 = {lvl: a for lvl, a in enumerate(mg.As)
                 if isinstance(a, DiaKernelOperator)}
        for a in on_k1.values():
            a.fused_launches = 0
        b = torch.ones(A.n_rows, device=dev)
        multigrid_cycle(mg, b, torch.zeros_like(b), n_pre=1, n_post=1)
        torch.cuda.synchronize()
        got = {k: c.launches for k, (c, _, _) in twins.items()}
        want = {k: n for k, (_, _, n) in twins.items()}
        require(got == want, (tag, got, want))
        fused = {lvl: a.fused_launches for lvl, a in on_k1.items()}
        require(fused == {lvl: 0 if lvl == last else 3 for lvl in on_k1},
                (tag, "fused launches", fused))
        checked = sa_fused_bitwise(mg, tag)
        require([c["level"] for c in checked]
                == [lvl for lvl in on_k1 if lvl != last], (tag, checked))
        gen = np.random.default_rng(41)
        for key in keys:
            csr, coo, per_cycle = twins[key]
            x = torch.from_numpy(gen.standard_normal(csr.shape[1]).astype(
                np.float32)).to(dev)
            y = csr(x)
            err = compare(y, csr.plain(x), f"K2 on SA{tag}.{key}")
            # every row at most WARP_ROW long: bitwise the CSR-order sum
            err["bitwise_csr_order"] = bool(torch.equal(
                y, csr_sequential(csr, x[:, None])[:, 0]))
            require(err["bitwise_csr_order"], (tag, key, err))
            lib_mat = csr_tensor(csr)
            compare(lib_mat @ x, y, f"cuSPARSE yardstick of SA{tag}.{key}")
            raw, bytes_moved, flops = csr_raw(lib, csr, x)
            bound_ms, bound_by = bound(bytes_moved, flops)
            lens = csr.row_ptr.diff()
            long_ = lens > LONG_ROW
            rows_out.append(dict(
                name=f"csr_spmv[SA{tag}.{key}]", route="cuda",
                source=K2_ROW[1], replaces=K2_ROW[2],
                launches_per_cycle=per_cycle,
                max_abs_err=err["max_abs_err"],
                bitwise_csr_order=err["bitwise_csr_order"],
                ms=cuda_ms_cold(raw, 20, flush),
                plain_ms=cuda_ms_cold(lambda: csr.plain(x), 5, flush),
                coo_ms=cuda_ms_cold(lambda: coo(x), 10, flush),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms_cold(lambda: lib_mat @ x, 20, flush),
                rows=csr.shape[0], cols=csr.shape[1], nnz=csr.nnz,
                long_row_share=float(long_.float().mean()),
                long_nnz_share=float(lens[long_].sum()) / csr.nnz,
                max_row=int(lens.max()), **k2_fields(csr)))
            del lib_mat
        if len(grid) == 2:
            rows_out += sa_fused_rows(mg, tag, lib, flush)
        summary[tag] = dict(
            grid=list(grid), swap_s=t_swap, fused_launches=fused,
            coarsest_chebyshev=coarsest_chebyshev(on_k1.get(last), sa, gen),
            fused_bitwise=checked, levels=[
                dict(rows=a.n_rows, nnz=a.nnz, kind=type(a).__name__)
                for a in mg.As], launches_per_cycle=got)
        del A, sa, mg, twins
        torch.cuda.empty_cache()
    emit(dict(phase="sa_k2", hierarchies=summary,
              rows=[{k: r[k] for k in ("name", "ms", "bound_ms", "plain_ms",
                                        "coo_ms", "library_ms",
                                        "long_row_share", "long_nnz_share",
                                        "row_blocks", "row_blocks_before",
                                        "warp_rows", "bitwise_csr_order",
                                        "unfused_ms", "k1_ms") if k in r}
                    for r in rows_out], nvidia_smi=smi))
    return rows_out


def sparse_close(got, want, rtol: float, atol: float, what: str) -> dict:
    """|got - want| <= rtol |want| + atol entrywise over the union of two
    operators' patterns (host float64; the patterns may differ where a
    Galerkin sum cancels exactly in one and not in the other)."""
    g, w = got.to_scipy(), want.to_scipy()
    require(g.shape == w.shape, (what, g.shape, w.shape))
    diff = abs(g - w)
    excess = float((diff - rtol * abs(w)).max())
    out = dict(what=what, max_abs_err=float(diff.max()), nnz=[g.nnz, w.nnz])
    require(excess <= atol, (out, excess))
    return out


def batch_block() -> GNBlock:
    """A GN block with per-graph globals g = [s, t]: c_ij = s A_ij x_j,
    y_i = x_i cbar_i + t, g' = [sum y, max A_ij, min x, mean x]."""
    def edge_fn(v_i, v_j, e, g):
        a = e[:, :1]
        return torch.cat([a, g[..., :1] * a * v_j[:, :1]], dim=1)

    def vertex_fn(v, e, agg, g):
        x = v[:, 0]
        return torch.stack([x, x * agg.sum(e[:, 1]) + g[..., 1]], dim=1)

    def global_fn(v, e, g, vagg, eagg):
        return torch.stack([vagg.sum(v[:, 1]), eagg.max(e[:, 0]),
                            vagg.min(v[:, 0]), vagg.mean(v[:, 0])], dim=-1)
    return GNBlock(edge_fn, vertex_fn, global_fn)


def gn_batched(dev) -> dict:
    """100 small-band matrices (n = 38, the learned smoother's batch) in
    one block-diagonal batch with per-graph globals, against 100
    single-graph calls of the same block."""
    ds = small_band_dataset(100, n=38, device=dev)
    ops = [ds.template.with_values(ds.vals[k]) for k in range(ds.n_graphs)]
    big, batch = batch_operators(ops)
    gen = np.random.default_rng(41)
    x = torch.from_numpy(gen.standard_normal(big.n_rows).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(gen.standard_normal((len(ops), 2)).astype(
        np.float32)).to(dev)
    blk = batch_block()
    out = blk(big, GraphState(vertices=x[:, None], edges=big.vals[:, None],
                              globals_=g), batch)
    singles_v, singles_g, off = [], [], 0
    for k, op in enumerate(ops):
        one = blk(op, GraphState(vertices=x[off:off + op.n_rows, None],
                                 edges=op.vals[:, None], globals_=g[k]))
        singles_v.append(one.vertices)
        singles_g.append(one.globals_)
        off += op.n_rows
    require(tuple(out.globals_.shape) == (len(ops), 4), out.globals_.shape)
    errs = [compare(torch.cat(unbatch_vertices(out.vertices,
                                               graph_sizes(ops))),
                    torch.cat(singles_v), "batched vertices"),
            compare(out.globals_, torch.stack(singles_g), "batched globals")]
    return dict(graphs=len(ops), vertices=big.n_rows, edges=big.nnz,
                results=errs)


def gn_phases(A, plain, fast, b, x_plain, S, t_setup, norm_row,
              smi) -> None:
    """Phases 23-25: `setup_twogrid(use_device_gnn=True)` at 1024^2, every
    GN-block form against its fused form on the kernels, and their
    times. Sets the launches of K4's normalize row (`norm_row`) to the
    count its gn_forms check takes."""
    dev, n = A.device, A.n_rows
    gs = (N_GRID, N_GRID)

    # --------------------------------------------------------- gn_setup
    t0 = time.perf_counter()
    gn = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0,
                       use_device_gnn=True)
    t_gn = time.perf_counter() - t0
    require(torch.equal(gn.coarse_flags, plain.coarse_flags),
            "device-GNN coarse flags differ from the host setup's")
    setup_errs = [sparse_close(gn.P, plain.P, 1e-5, 1e-6, "P"),
                  sparse_close(gn.Ac, plain.Ac, 1e-4, 1e-5, "Ac")]
    x = torch.zeros(n, device=dev)
    res = [float(torch.linalg.vector_norm(b - A.matvec(x)))]
    for _ in range(N_CYCLES):
        x = solve(gn, b, x, n_cycles=1)
        res.append(float(torch.linalg.vector_norm(b - A.matvec(x))))
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)
    require(bool(torch.isfinite(x).all()), "device-GNN x must be finite")
    rel = float((x - x_plain).abs().max() / x_plain.abs().max())
    require(rel <= 1e-4, rel)
    emit(dict(phase="gn_setup", setup_twogrid_device_gnn_s=t_gn,
              setup_twogrid_host_s=t_setup, nc=gn.P.shape[1],
              coarse_flags_identical=True, results=setup_errs,
              cycles=N_CYCLES, residual_norms=res, rel_err_vs_plain_x=rel,
              nvidia_smi=smi))
    del gn, x

    # --------------------------------------------------------- gn_forms
    gen = np.random.default_rng(43)

    def vec(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(dev)

    x, bb, b0 = vec(n), vec(n), vec(n)
    nc = plain.Ac.n_rows
    xc, bc = vec(nc), vec(nc)
    # the stream leg's kernel order (RCM) as a COO operator
    rp = S.fwd.row_ptr.cpu().numpy()
    A_rcm = SparseOperator.from_coo(
        np.repeat(np.arange(n), np.diff(rp)), S.fwd.cols.cpu().numpy(),
        S.fwd.vals.cpu().numpy().astype(np.float64), S.fwd.shape,
        coalesce=False, device=dev)
    xk, Xk = vec(n), vec(n, M_PROBES)
    W = A.scale(-1.0)  # positive definite: the weighted norm's W
    W_k1 = dia_kernel_operator(to_dia(W))
    A_nd = A.remove_diagonal()
    res_k4 = make_stencil_residual(A, gs)
    jac_k4 = make_stencil_jacobi(A, gs, omega=0.7, n_iters=3)
    pow_k4 = make_stencil_power(A, gs, n_iters=10)
    calls = {"K4_residual": res_k4._call, "K4_jacobi": jac_k4._call,
             "K4_power": pow_k4._call}
    for op in (fast.A, fast.Ac, W_k1, S.fwd):
        op.launches = 0
    S.fwd.launches_mm = 0
    for call in calls.values():
        call.launches = 0
    tol1 = dict(rtol=RTOL, atol_scale=RTOL)
    tol3 = dict(rtol=3 * RTOL, atol_scale=3 * RTOL)
    out = {}
    out["matvec_A_vs_K1"] = compare(matvec_gnn(A, x), matvec(fast.A, x),
                                    "matvec K1", **tol1)
    out["matvec_Arcm_vs_K2"] = compare(matvec_gnn(A_rcm, xk), S.fwd(xk),
                                       "matvec K2", **tol1)
    out["matvec_Arcm_X20_vs_K3"] = compare(matvec_gnn(A_rcm, Xk), S.fwd(Xk),
                                           "matvec K3", **tol1)
    r_gn = residual_gnn(A, bb, x)
    out["residual_vs_K1"] = compare(r_gn, residual(fast.A, bb, x),
                                    "residual K1", **tol1)
    out["residual_vs_K4"] = compare(r_gn, res_k4.residual(bb, x),
                                    "residual K4", **tol1)
    out["norm_vs_K1"] = compare(
        matrix_weighted_norm_gnn(W, x).reshape(1),
        matrix_weighted_norm(W_k1, x).reshape(1), "weighted norm K1",
        rtol=RTOL, atol_scale=0.0)
    j_gn = jacobi_gnn(A, bb, x, omega=0.7, n_iters=3)
    out["jacobi_vs_K1"] = compare(
        j_gn, jacobi(fast.A, bb, x, omega=0.7, n_iters=3), "jacobi K1",
        **tol3)
    out["jacobi_vs_K4"] = compare(j_gn, jac_k4.smooth(bb, x), "jacobi K4",
                                  **tol3)
    cheb = dict(c=-3.4, d=-4.0, deg=4)
    out["chebyshev_Ac_vs_K1"] = compare(
        chebyshev_gnn(plain.Ac, bc, xc, **cheb),
        chebyshev(fast.Ac, bc, xc, **cheb), "chebyshev K1",
        rtol=4 * RTOL, atol_scale=4 * RTOL)
    lam_gn, bv_gn = power_method_gnn(A, b0, n_iters=10)
    for key, (lam, bv) in (("K1", power_method(fast.A, b0, n_iters=10)),
                           ("K4", pow_k4.run(b0))):
        out[f"power_lambda_vs_{key}"] = compare(
            lam_gn.reshape(1), lam.reshape(1), f"power lambda {key}",
            rtol=RTOL, atol_scale=0.0)
        out[f"power_b_vs_{key}"] = compare(
            bv_gn, bv, f"power b {key}", rtol=10 * RTOL,
            atol_scale=10 * RTOL)
    torch.cuda.synchronize()
    launches = {"K1_A": fast.A.launches, "K1_Ac": fast.Ac.launches,
                "K1_W": W_k1.launches, "K2_Arcm": S.fwd.launches,
                "K3_Arcm": S.fwd.launches_mm,
                **{k: c.launches for k, c in calls.items()}}
    # K1 on A: matvec 1, residual 1, 3 sweeps, 10 power steps + Rayleigh
    want = {"K1_A": 1 + 1 + 3 + 11, "K1_Ac": 4, "K1_W": 1, "K2_Arcm": 1,
            "K3_Arcm": 1,
            **{k: stencil_launches(c.mode, c.n_steps, c.form.form)
               for k, c in calls.items()}}
    require(launches == want, (launches, want))
    norm_row["launches"] = launches["K4_power"]

    # the AMG forms against the setup's host formulas
    rows, cols, vals = A_nd.host_coo()
    strong_h = _soc_classic_host(rows, cols, vals, n, 0.25)
    s_gn = soc_classic(A_nd, 0.25)
    strong = (s_gn > 0).cpu().numpy()
    require(np.array_equal(strong, strong_h), "soc_classic strength differs")
    diag_h = A.host_diagonal()
    sa_gn = soc_sa(A_nd, A.diagonal()).cpu().numpy()
    sa_h = vals * vals / (diag_h[rows] * diag_h[cols])
    sa_err = float(np.max(np.abs(sa_gn - sa_h) / np.abs(sa_h)))
    require(sa_err <= 1e-6, ("soc_sa", sa_err))
    coarse = plain.coarse_flags.cpu().numpy().astype(np.float64)
    coarse_d = torch.from_numpy(coarse).float().to(dev)
    w_gn = direct_interp(A_nd, A.diagonal(), coarse_d, s_gn.gt(0).float()
                         ).cpu().numpy().astype(np.float64)
    strong_f = strong_h.astype(np.float64)
    w_raw = _direct_interp_raw(rows, cols, vals, diag_h, coarse, strong_f)
    w_host = _direct_interp_host(rows, cols, vals, diag_h, coarse, strong_f)
    fin = np.isfinite(w_gn)
    require(np.array_equal(fin, np.isfinite(w_raw))
            and np.array_equal(np.isnan(w_gn), np.isnan(w_raw)),
            "direct_interp's non-finite positions differ from the host's")
    require(np.allclose(w_gn[fin], w_host[fin], rtol=RTOL, atol=0.0),
            "direct_interp's finite weights differ from the host's")
    # SDDMM on a 64^2 pattern against the sampled dense product
    A64 = laplacian_2d(64, device=dev).eliminate_zeros()
    U, V = vec(A64.n_rows, 8), vec(A64.n_rows, 8)
    out["sddmm_64sq"] = compare(
        A64.sddmm(U, V), (U @ V.T)[A64.rows.long(), A64.cols.long()],
        "sddmm", **tol1)
    amg = dict(soc_classic_strong=int(strong.sum()),
               soc_classic_edges=int(strong.size),
               soc_sa_max_rel_err=sa_err,
               direct_interp_nonfinite=int((~fin).sum()),
               direct_interp_max_abs_err=float(np.max(
                   np.abs(w_gn[fin] - w_host[fin]))))
    emit(dict(phase="gn_forms", n=n, A_nnz=A.nnz, A_nodiag_nnz=A_nd.nnz,
              A_rcm_nnz=A_rcm.nnz, Ac_nnz=plain.Ac.nnz,
              dense_row_layout=dict(
                  A=A.nnz <= DENSE_LAYOUT_MAX_EDGES,
                  A_nodiag=A_nd.nnz <= DENSE_LAYOUT_MAX_EDGES,
                  Ac=plain.Ac.nnz <= DENSE_LAYOUT_MAX_EDGES),
              results=out, amg=amg, launches=launches,
              batched=gn_batched(dev), nvidia_smi=smi))

    # --------------------------------------------------------- gn_times
    forms = {  # form -> {variant: call}; "gn" is the GN-block form
        "matvec": dict(gn=lambda: matvec_gnn(A, x),
                       K1=lambda: matvec(fast.A, x)),
        "matvec_rcm": dict(gn=lambda: matvec_gnn(A_rcm, xk),
                           K2=lambda: S.fwd(xk)),
        "matvec_rcm_X20": dict(gn=lambda: matvec_gnn(A_rcm, Xk),
                               K3=lambda: S.fwd(Xk)),
        "residual": dict(gn=lambda: residual_gnn(A, bb, x),
                         K1=lambda: residual(fast.A, bb, x),
                         K4=lambda: res_k4.residual(bb, x)),
        "weighted_norm": dict(gn=lambda: matrix_weighted_norm_gnn(W, x),
                              K1=lambda: matrix_weighted_norm(W_k1, x)),
        "jacobi_3": dict(gn=lambda: jacobi_gnn(A, bb, x, omega=0.7,
                                               n_iters=3),
                         K1=lambda: jacobi(fast.A, bb, x, omega=0.7,
                                           n_iters=3),
                         K4=lambda: jac_k4.smooth(bb, x)),
        "chebyshev_Ac_4": dict(
            gn=lambda: chebyshev_gnn(plain.Ac, bc, xc, **cheb),
            K1=lambda: chebyshev(fast.Ac, bc, xc, **cheb)),
        "power_10": dict(gn=lambda: power_method_gnn(A, b0, n_iters=10),
                         K1=lambda: power_method(fast.A, b0, n_iters=10),
                         K4=lambda: pow_k4.run(b0)),
        "soc_classic": dict(gn=lambda: soc_classic(A_nd, 0.25)),
        "soc_sa": dict(gn=lambda: soc_sa(A_nd, A.diagonal())),
        "direct_interp": dict(gn=lambda: direct_interp(
            A_nd, A.diagonal(), coarse_d, s_gn.gt(0).float())),
    }
    def kernel_launches() -> int:
        return (fast.A.launches + fast.Ac.launches + W_k1.launches
                + S.fwd.launches + S.fwd.launches_mm
                + sum(c.launches for c in calls.values()))

    def window(c, fn):
        # a PyTorch op at each end of the window (no device work): a
        # window holding only the port's kernels came back empty from the
        # profiler on the H100
        torch.empty(0, device=dev)
        out = [fn() for _ in range(c)]
        torch.empty(0, device=dev)
        return out

    times = {}
    for form, variants in forms.items():
        row = {}
        for key, fn in variants.items():
            k0 = kernel_launches()
            fn()
            launched = kernel_launches() - k0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_ms(fn, iters=20)
            peak = torch.cuda.max_memory_allocated() - base
            prof = profile_cycles(lambda c, fn=fn: window(c, fn))
            row[key] = dict(ms=ms,
                            device_busy_ms=prof["device_busy_ms_per_cycle"],
                            device_ops_per_call=prof["launches_per_cycle"],
                            kernel_launches_per_call=launched,
                            peak_extra_bytes=peak)
        for key in variants:
            if key != "gn":
                row[f"gn_over_{key}"] = row["gn"]["ms"] / row[key]["ms"]
        times[form] = row
    t0 = time.perf_counter()
    _soc_classic_host(rows, cols, vals, n, 0.25)
    host_soc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _direct_interp_host(rows, cols, vals, diag_h, coarse, strong_f)
    host_interp_s = time.perf_counter() - t0
    emit(dict(phase="gn_times", iters=20, times=times,
              host_formula_s=dict(soc_classic=host_soc_s,
                                  direct_interp=host_interp_s),
              nvidia_smi=smi))


def rel_gap(got, want) -> float:
    """max |got - want| / |want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def f32_on(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def diffusion_data(dev, smi):
    """Phase 26: the diffusion model's dataset at the artifact's size and
    its split; returns (dataset, test split)."""
    t0 = time.perf_counter()
    ds = cosine_diffusion_dataset(DIFF_MATRICES, n=DIFF_N, max_freq=3.0,
                                  seed=41, cache_dir=None, device=dev)
    host_s = time.perf_counter() - t0
    # the 70/20/10 split as `train` derives it
    n_tr, n_va = int(0.7 * ds.n_graphs), int(0.2 * ds.n_graphs)
    perm = np.random.default_rng(41).permutation(ds.n_graphs)
    tr, va, te = (ds.select(perm[:n_tr]), ds.select(perm[n_tr:n_tr + n_va]),
                  ds.select(perm[n_tr + n_va:]))
    lay, _, kind = choose_edge_layout(ds.template_nodiag,
                                      grid_shape=(DIFF_N, DIFF_N))
    require(kind == "grid" and lay.k == 8, (kind, lay.k))
    require(bool(np.isfinite(ds.vals).all()) and ds.targets.shape == (
        DIFF_MATRICES, DIFF_N * DIFF_N, 2), "dataset shapes")
    emit(dict(phase="diffusion_data", matrices=ds.n_graphs,
              vertices=ds.template.n_rows, nnz=ds.template.nnz,
              offdiag_edges=ds.template_nodiag.nnz, layout=kind, k=lay.k,
              split=[tr.n_graphs, va.n_graphs, te.n_graphs],
              host_s=host_s, pool=pool_kind(DIFF_MATRICES),
              nvidia_smi=smi))
    SHARED["diffusion_ds"] = ds.select(np.arange(DIST_DIFF_MATRICES))
    return ds, te


def diffusion_serve(dev, ds, te, smi) -> DiffusionGNN:
    """Phase 27: the committed model served on the card; returns it."""
    with open(os.path.join(DIFF_ARTIFACT, "results.json")) as f:
        results = json.load(f)
    model = load_diffusion_params_npz(
        os.path.join(DIFF_ARTIFACT, "params.npz"),
        DiffusionGNN(**DIFF_CFG, device=dev))
    rel = edge_features(ds, DIFF_N)
    apply_b, pack = make_apply_banded(model, ds, rel, (DIFF_N, DIFF_N))
    ovb, d, g, y = (f32_on(a, dev) for a in (
        pack(te.offdiag_vals), te.diags, te.globals_, te.targets))

    def forward():
        with torch.no_grad():
            return apply_b(ovb, d, g)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pred = forward()
    loss = float(loss_terms(pred, y))
    peak = torch.cuda.max_memory_allocated() - base
    require(tuple(pred.shape) == (te.n_graphs, DIFF_N * DIFF_N, 2)
            and bool(torch.isfinite(pred).all()), tuple(pred.shape))
    gap_jax = abs(loss - JAX_CPU_TEST_LOSS) / JAX_CPU_TEST_LOSS
    gap_art = abs(loss - results["test_loss"]) / results["test_loss"]
    require(gap_jax <= 1e-4, (loss, JAX_CPU_TEST_LOSS))
    require(gap_art <= 0.10, (loss, results["test_loss"]))
    # the production grid path against the edge-order path, 4 graphs
    apply_e = make_apply(model, ds, rel)
    with torch.no_grad():
        pe = apply_e(f32_on(te.offdiag_vals[:4], dev), d[:4], g[:4])
    err = (pred[:4] - pe).abs()
    require(bool((err <= 1e-5 + 1e-4 * pe.abs()).all()), float(err.max()))
    ms = cuda_ms(forward, iters=10, warmup=2)
    busy = profile_cycles(lambda c: [forward() for _ in range(c)])
    emit(dict(phase="diffusion_serve", graphs=te.n_graphs,
              test_loss=loss, jax_cpu_test_loss=JAX_CPU_TEST_LOSS,
              rel_gap_jax_cpu=gap_jax,
              results_json_test_loss=results["test_loss"],
              rel_gap_results_json=gap_art,
              grid_vs_edge_max_abs_err=float(err.max()),
              ms_per_forward=ms,
              device_busy_ms_per_forward=busy["device_busy_ms_per_cycle"],
              idle_share=1.0 - busy["device_busy_ms_per_cycle"] / ms,
              device_ops_per_forward=busy["launches_per_cycle"],
              top_kernels_per_forward=busy["top_kernels_per_cycle"][:6],
              peak_mem_bytes_above_inputs=peak, nvidia_smi=smi))
    return model


def diffusion_eval(dev, model, smi) -> None:
    """Phase 28: the OOD sweep and the frequency study on the card."""
    with open(os.path.join(DIFF_ARTIFACT, "results.json")) as f:
        by_decade = json.load(f)["ood_loss_by_decade"]
    t0 = time.perf_counter()
    ood = ood_extrapolation(None, model, n=DIFF_N)
    ood_s = time.perf_counter() - t0
    require(bool(np.isfinite(ood["loss"]).all()), ood["loss"])
    require(rel_gap(ood["loss"], JAX_CPU_OOD_LOSS) <= 1e-4,
            (ood["loss"].tolist(), JAX_CPU_OOD_LOSS))
    t0 = time.perf_counter()
    freqs, errors = freq_study_errors(None, model, n=DIFF_N, max_freq=4.0)
    freq_s = time.perf_counter() - t0
    require(errors.shape == (9, 9) and bool(np.isfinite(errors).all()),
            errors.shape)
    require(rel_gap(errors, JAX_CPU_FREQ_ERRORS) <= 1e-4,
            rel_gap(errors, JAX_CPU_FREQ_ERRORS))
    with np.load(os.path.join(DIFF_ARTIFACT, "freq_study.npz")) as z:
        require(np.array_equal(freqs, z["freqs"]), freqs)
        freq_art = z["errors"]
    emit(dict(phase="diffusion_eval", ood_alpha=ood["alpha"].tolist(),
              ood_loss=ood["loss"].tolist(),
              ood_rel_gap_jax_cpu=rel_gap(ood["loss"], JAX_CPU_OOD_LOSS),
              ood_rel_gap_artifact=rel_gap(ood["loss"], [
                  by_decade[f"{a:.0e}"] for a in ood["alpha"]]),
              freq_mean_err=float(errors.mean()),
              freq_max_err=float(errors.max()),
              freq_rel_gap_jax_cpu=rel_gap(errors, JAX_CPU_FREQ_ERRORS),
              freq_rel_gap_artifact=rel_gap(errors, freq_art),
              ood_s=ood_s, freq_s=freq_s, nvidia_smi=smi))


def diffusion_train(dev, ds, smi) -> None:
    """Phase 29: `train` on the card for 3 epochs at the artifact's
    configuration; then ms per step and the idle share of its steps."""
    cfg = TrainDiffusionConfig(num_matrices=DIFF_MATRICES, n_mesh=DIFF_N,
                               max_freq=3.0, epochs=3, batch_size=64,
                               lr=1e-2, seed=41, cache_dir=None,
                               log_every=0, **DIFF_CFG)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, hist = train_diffusion(cfg, dataset=ds, device=dev)
    train_s = time.perf_counter() - t0
    # the whole run: its splits on the card, 200 validation graphs a call
    train_peak = torch.cuda.max_memory_allocated() - base
    losses = hist["train_loss"] + hist["val_loss"] + [hist["test_loss"]]
    require(bool(np.isfinite(losses).all()), hist)
    require(hist["train_loss"][2] < hist["train_loss"][0], hist)

    # the step alone: one batch of 64 training graphs, steps 2 onward
    rel = edge_features(ds, DIFF_N)
    apply_b, pack = make_apply_banded(model, ds, rel, (DIFF_N, DIFF_N))
    idx = np.random.default_rng(41).permutation(ds.n_graphs)[:64]
    part = ds.select(idx)
    batch = tuple(f32_on(a, dev) for a in (
        pack(part.offdiag_vals), part.diags, part.globals_, part.targets))
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    plateau = PlateauScale(opt)

    def step():
        return train_step(model, opt, plateau,
                          lambda ov, d, g, y: loss_terms(apply_b(ov, d, g),
                                                         y),
                          batch, np.inf)

    first = float(step())  # step 1: the allocator's first pass
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, iters=9, warmup=0)
    peak = torch.cuda.max_memory_allocated() - base
    busy = profile_cycles(lambda c: [step() for _ in range(5 * c)])
    busy_ms = busy["device_busy_ms_per_cycle"] / 5
    require(np.isfinite(first), first)
    emit(dict(phase="diffusion_train", tf32=False, epochs=3,
              steps_per_epoch=int(0.7 * DIFF_MATRICES) // 64,
              history=hist, train_s=train_s,
              train_peak_mem_bytes=train_peak,
              ms_per_step=ms, device_busy_ms_per_step=busy_ms,
              idle_share=1.0 - busy_ms / ms,
              top_kernels_per_5_steps=busy["top_kernels_per_cycle"][:6],
              peak_mem_bytes_above_inputs=peak, nvidia_smi=smi))


def eigen_phase(dev, smi) -> None:
    """Phase 30: the Jacobi model's dense eigen analysis on 8 test
    matrices, the MLP on the card, against test_eigenvalues.npz.

    The non-learned arrays are host float64 on the same float32 matrices:
    equal to rtol 1e-8. The learned ones carry the MLP, whose TPU matmuls
    rounded through bf16: D^-1 within DINV_RTOL (delta) of the artifact's.
    A relative change E of D^-1 (|E_ii| <= delta) changes the restricted
    matrix X = V^T omega D^-1 A V by V^T E omega D^-1 A V, of 2-norm at most
    delta ||omega D^-1 A||_2 <= delta sqrt(||.||_1 ||.||_inf) (V has
    orthonormal columns); each sorted |eigenvalue| of I - X is held to
    move by no more (Bauer-Fike with a condition number of 1)."""
    t0 = time.perf_counter()
    ds = small_band_dataset(1000, n=38, h_low=5e-4, seed=54681,
                            cache_dir=None, device=dev)
    data_s = time.perf_counter() - t0
    SHARED["jacobi_ds"] = ds  # the Jacobi trainer's default data
    perm = np.random.default_rng(54681).permutation(ds.n_graphs)
    te = ds.select(perm[850:1000])
    t0 = time.perf_counter()
    got = eigen_analysis(os.path.join(ARTIFACT, "params.npz"), te,
                         max_graphs=8)
    eig_s = time.perf_counter() - t0
    with np.load(os.path.join(ARTIFACT, "test_eigenvalues.npz")) as z:
        want = {k: z[k][:8] for k in z.files}
    exact = {}
    for k in EIGEN_EXACT + ("hs", "band_locs"):
        err = np.abs(got[k] - want[k])
        exact[k] = float(np.max(err / np.abs(want[k])))
        require(bool((err <= 1e-8 * np.abs(want[k])).all()), (k, exact[k]))
    dinv_gap = np.abs(got["diag_learn_Dinv"] - want["diag_learn_Dinv"]) / \
        np.abs(want["diag_learn_Dinv"])
    require(float(dinv_gap.max()) <= DINV_RTOL, float(dinv_gap.max()))
    evals_gap, evals_tol = [], []
    for i in range(8):
        dinv = got["diag_learn_Dinv"][i]
        A = te.template.with_values(te.vals[i].astype(np.float32)).to_dense(
        ).double().cpu().numpy()
        X = dinv[:, None] * A   # omega D^-1 A (diag_learn_Dinv = omega / d)
        tol = DINV_RTOL * np.sqrt(np.abs(X).sum(0).max()
                                  * np.abs(X).sum(1).max())
        gap = float(np.abs(got["evals_learn_DinvA"][i]
                           - want["evals_learn_DinvA"][i]).max())
        require(gap <= tol, (i, gap, tol))
        evals_gap.append(gap)
        evals_tol.append(float(tol))
    damping = {k: dict(port=got[k].max(axis=1).tolist(),
                       artifact=want[k].max(axis=1).tolist())
               for k in ("evals_learn_DinvA", "evals_DinvA",
                         "evals_TwoThirds_DinvA", "evals_opt_DinvA")}
    emit(dict(phase="eigen", matrices=8, n=int(te.template.n_rows),
              exact_max_rel_err=exact,
              dinv_learn_max_rel_gap=float(dinv_gap.max()),
              dinv_learn_mean_rel_gap=float(dinv_gap.mean()),
              evals_learn_max_abs_gap=evals_gap,
              evals_learn_tolerance=evals_tol,
              high_freq_damping=damping, dataset_s=data_s,
              eigen_s=eig_s, nvidia_smi=smi))


def health_row(lib, launches: int, flush: torch.Tensor) -> dict:
    """K5's row of the kernels line: y = 2 x on one (8, 128) f32 block,
    bitwise its plain version on random x. The raw launch (`ms`, as for
    K1-K4), the wrapper (checks, allocation, launch: `wrapper_ms`) and
    `torch.mul(x, 2)` are timed in turns, L2 flushed; beside them each
    kernel's device time from the profiler (`warm_and_device_ms`), which
    no launch latency enters. Bound = 8 KB moved (4 KB read, 4 KB written) at the memory
    rate, so the launch sets the time."""
    x = torch.from_numpy(np.random.default_rng(53).standard_normal(
        HEALTH_SHAPE).astype(np.float32)).to(flush.device)
    y, want = health_cuda(x), health_plain(x)
    torch.cuda.synchronize()
    require(torch.equal(y, want), "K5 is not bitwise 2 * x")
    require(torch.equal(torch.mul(x, 2), want), "torch.mul(x, 2) != 2 * x")
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        _build.check(lib.health_f32(x.data_ptr(), y.data_ptr(), x.numel(),
                                    stream), "K5 raw")

    def mul():
        return torch.mul(x, 2)
    t = cold_ms_turns({"raw": raw, "wrapper": lambda: health_cuda(x),
                       "library": mul}, 50, flush)
    bound_ms, bound_by = bound(2 * x.numel() * 4, x.numel())
    return dict(name="health[8x128]", route="cuda", source=K5_ROW[0],
                replaces=K5_ROW[1], launches=launches,
                max_abs_err=float((y - want).abs().max()),
                ms=t["raw"],
                plain_ms=cuda_ms_cold(lambda: health_plain(x), 20, flush),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=t["library"], wrapper_ms=t["wrapper"],
                device_ms=warm_and_device_ms(raw)["device_ms_per_launch"],
                library_device_ms=warm_and_device_ms(mul)[
                    "device_ms_per_launch"])


def peak_above(fn) -> int:
    """Bytes the card's allocator held at peak during fn() above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def bsr_phase(A_p, S, flush, smi) -> None:
    """Phase 31: BSR (ops/bsr.py) on the stream leg's RCM-ordered A at
    1,048,576 rows against K2 and K3 on the same CSR, and RCM against the
    shuffled pattern's block count."""
    require(not torch.backends.cuda.matmul.allow_tf32,
            "the BSR block product must run in full f32 (TF32 is on)")
    dev, n, B, m = A_p.device, A_p.n_rows, BSR_BLOCK, M_PROBES
    t0 = time.perf_counter()
    A_rcm, _ = permute(A_p, S.perm.cpu().numpy())
    t_permute = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsr = to_bsr(A_rcm, block_size=B)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    nb = bsr.blocks.shape[0]
    blocks_bytes = bsr.blocks.numel() * bsr.blocks.element_size()
    idx_bytes = 2 * nb * bsr.block_rows.element_size()

    gen = np.random.default_rng(59)
    x = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(dev)
    X = torch.from_numpy(gen.standard_normal((n, m)).astype(
        np.float32)).to(dev)
    csr = S.fwd  # the CSR of A_rcm: K2 on x, K3 on X
    errs = {"spmv_vs_k2": compare(bsr @ x, csr(x), "BSR SpMV against K2"),
            "spmm_vs_k3": compare(bsr @ X, csr(X), "BSR SpMM against K3")}
    diag_exact = bool(torch.equal(bsr.diagonal(), A_rcm.diagonal()))
    require(diag_exact, "BSR diagonal() differs from A_rcm's")

    lib = _build.load()
    _, k2_bytes, k2_flops = csr_raw(lib, csr, x)
    k3_bytes = csr.nnz * 8 + (n + 1) * 4 + 2 * n * m * 4
    times = {}
    for key, fn, kern, bytes_moved, flops, k_bytes, k_flops in (
            ("spmv", lambda: bsr @ x, lambda: csr(x),
             blocks_bytes + idx_bytes + 2 * n * 4, 2 * nb * B * B,
             k2_bytes, k2_flops),
            ("spmm", lambda: bsr @ X, lambda: csr(X),
             blocks_bytes + idx_bytes + 2 * n * m * 4, 2 * nb * B * B * m,
             k3_bytes, 2 * csr.nnz * m)):
        bound_ms, bound_by = bound(bytes_moved, flops)
        k_bound_ms, k_bound_by = bound(k_bytes, k_flops)
        times[key] = dict(
            ms=cuda_ms_cold(fn, 10, flush), bound_ms=bound_ms,
            bound_by=bound_by, bytes=bytes_moved, flops=flops,
            peak_bytes=peak_above(fn),
            kernel_ms=cuda_ms_cold(kern, 20, flush),
            kernel_bound_ms=k_bound_ms, kernel_bound_by=k_bound_by,
            kernel="K2" if key == "spmv" else "K3")
        times[key]["ms_over_kernel"] = (times[key]["ms"]
                                        / times[key]["kernel_ms"])
    del bsr

    # RCM (scipy) on the shuffled operator against its block count,
    # counted on the host. The shuffled pattern's BSR would not fit on the
    # card (some 4e6 blocks of 64 KB): `to_bsr` is held to the blocks half
    # the free memory holds, and must refuse it before allocating
    rows, cols, _ = A_p.host_coo()
    nbc = -(-n // B)
    nb_shuf = int(np.unique((rows // B) * nbc + cols // B).size)
    cap = min(BSR_MAX_BLOCKS,
              torch.cuda.mem_get_info(dev)[0] // 2 // (B * B * 4))
    refusal = None
    try:
        to_bsr(A_p, block_size=B, max_blocks=cap)
    except ValueError as e:
        refusal = str(e)
    require(nb_shuf > cap and refusal == f"pattern needs {nb_shuf} blocks "
            f"(> {cap})", (nb_shuf, cap, refusal))
    t0 = time.perf_counter()
    perm2 = rcm_permutation(A_p)
    A_rcm2, _ = permute(A_p, perm2)
    t_rcm = time.perf_counter() - t0
    bsr2 = to_bsr(A_rcm2, block_size=B)
    nb_rcm2 = bsr2.blocks.shape[0]
    del bsr2, A_rcm2
    require(nb_rcm2 < nb_shuf, (nb_rcm2, nb_shuf))
    emit(dict(phase="bsr", n=n, nnz=A_rcm.nnz, block_size=B, blocks=nb,
              bytes=blocks_bytes, slot_waste=nb * B * B / A_rcm.nnz,
              permute_s=t_permute, build_s=t_build,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              results=list(errs.values()), diagonal_exact=diag_exact,
              times=times, shuffled_blocks=nb_shuf,
              shuffled_max_blocks=cap, shuffled_refusal=refusal,
              scipy_rcm_blocks=nb_rcm2, scipy_rcm_s=t_rcm, nvidia_smi=smi))


def run_module(args, timeout: int) -> tuple:
    """(completed process, seconds) of `python -m <args>` from the root of
    the checkout, on the card."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p, time.perf_counter() - t0


def finite_losses(out: str, what: str) -> list:
    """The epoch and test-loss lines of a trainer's output; each number
    finite, and a test loss printed."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("epoch ", "test loss"))]
    vals = [float(v) for ln in lines for v in re.findall(
        r"(?:train|val|loss:) (\S+)", ln)]
    require(any(ln.startswith("test loss") for ln in lines)
            and vals and all(np.isfinite(vals)), (what, lines))
    return lines


def cli_examples_phases(smi) -> None:
    """Phases 32-33: the port's CLI and the example twins, each a
    `python -m` subprocess on the card; the five run at once (each
    process spends seconds reaching the card and building its data on
    the host), so their seconds include sharing the host and the card."""
    with tempfile.TemporaryDirectory() as cache:
        runs = {  # key -> module and arguments
            "num_combos": ["diffusion", "--num-combos"],
            # the committed model's combination and mesh at full width
            "diffusion": ["diffusion", "--start-index", "1", "--end-index",
                          "2", "--num-matrices", "100", "--n-mesh", "80",
                          "--epochs", "2"],
            "jacobi": ["jacobi", "--epochs", "1"],
            "refusal": ["jacobi", "--num-matrices", "12"]}
        jobs = {k: ["gnnla_tpu_torch.cli", *v, "--cache-dir", cache]
                for k, v in runs.items()}
        jobs["examples"] = ["gnnla_tpu_torch.examples.run_all"]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as pool:
            futs = {k: pool.submit(run_module, v, 300)
                    for k, v in jobs.items()}
            done = {k: f.result() for k, f in futs.items()}
        wall = time.perf_counter() - t0
        out = {k: dict(argv=runs[k], rc=done[k][0].returncode,
                       seconds=done[k][1]) for k in runs}

        p = done["num_combos"][0]
        require(p.returncode == 0 and p.stdout.strip()
                == "There are 5 total combinations", (p.stdout, p.stderr))
        p = done["diffusion"][0]
        require(p.returncode == 0, p.stderr[-4000:])
        require(p.stdout.startswith("Combination 1: seed=41 encoder=(3, 16)"
                                    " decoder=None ext=1 int=2 hidden=32"),
                p.stdout)
        out["diffusion"]["lines"] = finite_losses(p.stdout, "diffusion")
        p = done["jacobi"][0]
        require(p.returncode == 0, p.stderr[-4000:])
        out["jacobi"]["lines"] = finite_losses(p.stdout, "jacobi")
        p = done["refusal"][0]
        require(p.returncode != 0 and "at least 851 matrices" in p.stderr,
                (p.returncode, p.stderr[-2000:]))
        require(not any(f.startswith("smallband_12_")
                        for f in os.listdir(cache)),
                "the refused run built data")
    emit(dict(phase="cli", runs=out, wall_s=wall, nvidia_smi=smi))

    p, secs = done["examples"]
    ok = dict(re.findall(r"^--- (\w+) ok \(([\d.]+)s\)$", p.stdout,
                         re.MULTILINE))
    require(p.returncode == 0 and sorted(ok) == sorted(EXAMPLES),
            (p.returncode, p.stdout[-4000:], p.stderr[-4000:]))
    emit(dict(phase="examples", passed=len(ok), seconds=secs,
              example_s={k: float(v) for k, v in ok.items()},
              nvidia_smi=smi))


# ------------------------------------------------------------ distribution
def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
           what: str) -> dict:
    """|got - want| <= atol + rtol |want| elementwise (the JAX tests'
    assert_allclose); raises otherwise."""
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    out = dict(what=what, rtol=rtol, atol=atol, max_abs_err=float(err.max()),
               max_rel_err=float(err.max() / want.abs().max()))
    if not ok:
        raise AssertionError(f"{what}: sharded result disagrees {out}")
    return out


def dist_init(store: str, smi) -> object:
    """Phase 34: a world of one NCCL rank on the card and its row mesh; a
    1-rank ring gives x back."""
    dev = initialize_distributed(f"file://{store}", 1, 0, device="cuda")
    mesh = global_row_mesh()
    g = axis_group(mesh, "rows")
    x = torch.arange(8.0, device=dev)
    require(ring_shift(x, 1, g) is x and torch.equal(psum(x, g), x),
            "a 1-rank ring is the identity")
    emit(dict(phase="dist_init", backend=dist.get_backend(g),
              world_size=dist.get_world_size(g),
              nccl=".".join(map(str, torch.cuda.nccl.version())),
              device=str(dev), mesh=str(mesh), nvidia_smi=smi))
    return mesh


def dist_spmv(A, mesh, smi) -> None:
    """Phase 35: the row-partitioned COO path at 1024^2 against the
    port's single-device twins, within tests/test_parallel.py's
    tolerances."""
    dev, n = A.device, A.n_rows
    t0 = time.perf_counter()
    part = partition_rows(A, dist.get_world_size())
    part_s = time.perf_counter() - t0
    gen = np.random.default_rng(24601)
    x_h, b_h = (gen.random(n).astype(np.float32) for _ in range(2))
    x, b = (torch.from_numpy(v).to(dev) for v in (x_h, b_h))

    def put(v):
        return local_block(shard_vector(v, part), mesh)

    def whole(v_l):
        return unshard_vector(gather_vector(v_l, mesh), part)

    xs, bs = put(x), put(b)
    mv = make_sharded_matvec(part, mesh)
    res = [within(whole(mv(xs)), A.matvec(x), 1e-5, 1e-5, "matvec")]
    sweep = make_sharded_jacobi(part, mesh)(
        bs, xs, put(torch.from_numpy(A.host_diagonal().astype(
            np.float32)).to(dev)), 0.7, 10)
    res.append(within(whole(sweep), jacobi(A, b, x, omega=0.7, n_iters=10),
                      1e-4, 1e-4, "10 Jacobi sweeps"))
    nrm = make_sharded_norm(part, mesh)(xs)
    res.append(within(nrm, torch.linalg.vector_norm(x), 1e-5, 0.0, "norm"))
    lam, _ = make_sharded_power_method(part, mesh)(xs, 30)
    res.append(within(lam, power_method(A, x, n_iters=30)[0], 1e-4, 0.0,
                      "power method, 30 steps"))
    emit(dict(phase="dist_spmv", n=n, partition_s=part_s, halo=part.halo,
              halo_reach=part.halo_reach, results=res,
              ms_sharded_matvec=cuda_ms(lambda: mv(xs), iters=20),
              ms_matvec=cuda_ms(lambda: A.matvec(x), iters=20),
              nvidia_smi=smi))


def dist_stream(A_p, mesh, lib, flush, smi) -> list:
    """Phase 36: K2 per shard on the stream leg's shuffled A with a forced
    halo, against K2 on the same RCM-ordered, padded CSR whole; the x and
    values cotangents. Returns the two K2 rows, their launches still to
    be filled by the main path's run."""
    dev, n = A_p.device, A_p.n_rows
    t0 = time.perf_counter()
    kern = build_sharded_stream(A_p, mesh, with_grad=True, min_halo_tiles=1)
    build_s = time.perf_counter() - t0
    require(kern.h_tiles >= 1, kern.h_tiles)
    B, perm = rcm_csr(A_p.to_scipy().tocsr())
    require(np.array_equal(perm, kern.perm), "the shards' RCM order")
    N = kern.padded_len
    Bp = _pad_square(B, N)
    Bp.sort_indices()
    whole = CsrSpMV(Bp, device=dev)
    Bt = Bp.T.tocsr()
    Bt.sort_indices()
    whole_t = CsrSpMV(Bt, device=dev)

    gen = np.random.default_rng(13)
    x_l = kern.shard(kern.to_padded(gen.standard_normal(n)))
    w_l = kern.shard(kern.to_padded(gen.standard_normal(n)))
    kern.fwd.launches = 0
    y = kern.apply(x_l)
    torch.cuda.synchronize()
    per_apply = kern.fwd.launches
    require(per_apply == 1, per_apply)
    y_ref = whole(x_l)  # one rank: its block is the whole padded vector
    bitwise = bool(torch.equal(y, y_ref))
    gap = float((y - y_ref).abs().max() / y_ref.abs().max())
    require(bitwise or gap <= RTOL, gap)

    # the cotangents of <w, A x>: x's against K2 on A^T whole, the values'
    # against w[row] * x[col] and its sum against the host pattern sum
    vals = kern.diff_args.detach().clone().requires_grad_(True)
    xg = x_l.clone().requires_grad_(True)
    kern.fwd.transpose.launches = 0
    dvals, xbar = torch.autograd.grad(
        torch.sum(w_l * kern.apply_diff(vals, xg)), (vals, xg))
    torch.cuda.synchronize()
    bwd_launches = kern.fwd.transpose.launches
    require(bwd_launches == 1, bwd_launches)
    x_err = compare(xbar, whole_t(w_l), "x cotangent against A^T w")
    x_ext = kern.extend(x_l)
    prod = (w_l.index_select(0, entry_rows(kern.fwd.row_ptr, kern.fwd.nnz))
            * x_ext.index_select(0, kern.fwd.cols))
    require(torch.equal(dvals, prod), "values cotangent = w[row] x[col]")
    coo = Bp.tocoo()
    w_h, x_h = w_l.double().cpu().numpy(), x_l.double().cpu().numpy()
    ref_sum = float(np.sum(w_h[coo.row] * x_h[coo.col]))
    d64 = dvals.double()
    sum_gap = abs(float(d64.sum()) - ref_sum) / float(d64.abs().sum())
    require(sum_gap < 1e-5, sum_gap)

    rows = []
    for key, csr, vin, err in (
            ("A_rcm_shard", kern.fwd, x_ext,
             compare(kern.fwd(x_ext), kern.fwd.plain(x_ext), "A_rcm shard")),
            ("A_rcm_shard_T, backward", kern.fwd.transpose, w_l, x_err)):
        raw, bytes_moved, flops = csr_raw(lib, csr, vin)
        lib_mat = csr_tensor(csr)
        bound_ms, bound_by = bound(bytes_moved, flops)
        rows.append(dict(
            name=f"csr_spmv[{key}]", route="cuda", source=K2_ROW[1],
            replaces=K2_ROW[2], via="gnnla_tpu/parallel/stream.py:145",
            launches=None, max_abs_err=err["max_abs_err"],
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: csr.plain(vin), 5, flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms_cold(lambda: lib_mat @ vin, 20, flush),
            shape=list(csr.shape), nnz=csr.nnz, **k2_fields(csr)))
        del lib_mat
    rows[1]["launches"] = bwd_launches
    whole_raw = csr_raw(lib, whole, x_l)[0]
    emit(dict(phase="dist_stream", n=n, padded=N, h_tiles=kern.h_tiles,
              shard_shape=list(kern.fwd.shape), build_s=build_s,
              y_bitwise_whole_k2=bitwise, y_max_rel_gap=gap,
              k2_launches_per_apply=per_apply,
              backward_k2_launches=bwd_launches,
              x_cotangent=x_err, values_sum_rel_gap=sum_gap,
              sharded_apply_ms=cuda_ms_cold(lambda: kern.apply(x_l), 20,
                                            flush),
              shard_k2_ms=rows[0]["ms"],
              whole_k2_ms=cuda_ms_cold(whole_raw, 20, flush),
              nvidia_smi=smi))
    return rows


def dist_vcycle(setup_p, mesh, k2_row, smi) -> None:
    """Phase 37: 3 cycles of the sharded two-grid cycle with the fine
    level on K2 shards, and of the COO one, on the shuffled 1024^2
    Laplacian, against the single-device `vcycle` on the same setup
    (1e-4 of max|x|). The K2 shard's launches of this run fill its row."""
    dev = setup_p.A.device
    n = setup_p.A.n_rows
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n).astype(
        np.float32)).to(dev)
    x_ref = solve(setup_p, b, torch.zeros(n, device=dev), n_cycles=3)
    scale = float(x_ref.abs().max())
    t0 = time.perf_counter()
    cycle, kern = make_sharded_stream_vcycle(setup_p, mesh,
                                             min_halo_tiles=1)
    stream_s = time.perf_counter() - t0
    b_l = kern.shard(kern.to_padded(b))
    x_l = torch.zeros_like(b_l)
    kern.fwd.launches = 0
    for _ in range(3):
        x_l = cycle(b_l, x_l)
    torch.cuda.synchronize()
    launches = kern.fwd.launches
    # 3 pre + 3 post sweeps and the residual per cycle
    require(launches == 7 * 3, launches)
    k2_row["launches"] = launches
    x_st = torch.from_numpy(kern.from_padded(kern.gather(x_l))).to(dev)
    rel_stream = float((x_st - x_ref).abs().max()) / scale
    require(rel_stream <= 1e-4, rel_stream)

    t0 = time.perf_counter()
    ccycle, part = make_sharded_vcycle(setup_p, mesh)
    coo_s = time.perf_counter() - t0
    bc = local_block(shard_vector(b, part), mesh)
    xc = torch.zeros_like(bc)
    for _ in range(3):
        xc = ccycle(bc, xc)
    x_coo = unshard_vector(gather_vector(xc, mesh), part)
    rel_coo = float((x_coo - x_ref).abs().max()) / scale
    require(rel_coo <= 1e-4, rel_coo)
    z, zc = torch.zeros_like(b_l), torch.zeros_like(bc)
    emit(dict(phase="dist_vcycle", n=n, cycles=3, h_tiles=kern.h_tiles,
              k2_launches=launches, rel_err_stream=rel_stream,
              rel_err_coo=rel_coo, build_s=dict(stream=stream_s, coo=coo_s),
              ms_per_cycle_stream=cuda_ms(lambda: cycle(b_l, z), iters=10),
              ms_per_cycle_coo=cuda_ms(lambda: ccycle(bc, zc), iters=3,
                                       warmup=1),
              ms_per_cycle_auto_stream=SHARED["stream_ms_per_cycle"],
              nvidia_smi=smi))


def dist_mgpcg(A, b, mesh, smi) -> None:
    """Phase 38: sharded mg_pcg on the SA hierarchy (COO levels, 2
    sharded): 15 +- 1 iterations to 1e-8 ||b||, x within 1e-4 of max|x|
    of the single-device mg_pcg on the same levels."""
    sa, ref = SHARED["sa"], jax_bench_reference()
    bnorm = float(torch.linalg.vector_norm(b))
    t0 = time.perf_counter()
    solve_sh, part = make_sharded_mg_pcg(sa, mesh, flip_sign=True,
                                         n_sharded_levels=2)
    build_s = time.perf_counter() - t0
    b_l = local_block(shard_vector(b, part), mesh)
    z = torch.zeros_like(b_l)
    x_l, hist = solve_sh(b_l, z, PCG_ITERS)
    conv = np.flatnonzero(hist / bnorm < 1e-8)
    require(conv.size > 0, f"no 1e-8 in {PCG_ITERS} iterations: {hist}")
    iters = int(conv[0]) + 1
    require(abs(iters - ref["pcg_iters_to_1e8"]) <= 1,
            (iters, ref["pcg_iters_to_1e8"]))
    x = unshard_vector(gather_vector(x_l, mesh), part)
    x_one, _ = mg_pcg(sa, b, torch.zeros_like(b), n_iters=PCG_ITERS,
                      flip_sign=True)
    rel = float((x - x_one).abs().max() / x_one.abs().max())
    require(rel <= 1e-4, rel)
    ms_iter = float(np.median([cuda_ms(lambda: solve_sh(b_l, z, iters),
                                       iters=1, warmup=1)
                               for _ in range(3)])) / iters
    emit(dict(phase="dist_mgpcg", levels=sa.n_levels, sharded_levels=2,
              iters_to_1e8=iters, jax_bench_iters=ref["pcg_iters_to_1e8"],
              rel_err_vs_single_device=rel,
              true_rel_residual=float(torch.linalg.vector_norm(
                  b - A.matvec(x))) / bnorm,
              build_s=build_s, ms_per_iteration=ms_iter,
              ms_per_iteration_sa_mg_pcg=SHARED["mg_pcg_ms_per_iter"],
              nvidia_smi=smi))


def dist_train(smi) -> None:
    """Phase 39: data-parallel training on a 1-rank "data" mesh against
    the same runs without one (losses within 1e-6): train_jacobi at its
    defaults for 1 epoch, train_diffusion combination 1 at n = 80 on 100
    matrices for 1 epoch."""
    from torch.distributed.device_mesh import init_device_mesh

    data = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    out = {}
    runs = (
        ("jacobi", train, TrainJacobiConfig(epochs=1, cache_dir=None,
                                            log_every=0),
         SHARED["jacobi_ds"]),
        ("diffusion", train_diffusion, TrainDiffusionConfig(
            **DIFF_CFG, num_matrices=DIST_DIFF_MATRICES, n_mesh=DIFF_N,
            epochs=1, cache_dir=None, log_every=0), SHARED["diffusion_ds"]))
    for key, fn, cfg, ds in runs:
        t0 = time.perf_counter()
        _, h_mesh = fn(cfg, dataset=ds, mesh=data)
        mesh_s = time.perf_counter() - t0
        _, h_one = fn(cfg, dataset=ds)
        gaps = {}
        for k in ("train_loss", "val_loss", "test_loss"):
            got, want = np.asarray(h_mesh[k]), np.asarray(h_one[k])
            require(np.all(np.isfinite(got)), (key, k, got))
            gaps[k] = float(np.max(np.abs(got - want) / np.abs(want)))
            require(gaps[k] <= 1e-6, (key, k, got, want))
        out[key] = dict(losses={k: h_mesh[k] for k in (
            "train_loss", "val_loss", "test_loss")}, rel_gaps=gaps,
            seconds_with_mesh=mesh_s)
    emit(dict(phase="dist_train", runs=out, nvidia_smi=smi))


def dist_rank(rank: int, store: str, out: str, backend: str) -> None:
    """One of two processes on card 0 (phase 40), spawned. "gloo": the
    sharded COO matvec, K2 per shard, 3 V-cycles on K2 shards at 256^2
    shuffled and 2 data-parallel Jacobi steps, each against this rank's
    single-device result within the CPU tests' tolerances; gloo moves the
    card's tensors through pinned host memory. "nccl": whether NCCL takes
    two ranks on one card (the outcome is the result)."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    if backend == "nccl":
        initialize_distributed(f"file://{store}", 2, rank, device=dev,
                               timeout=60)
        try:
            dist.all_reduce(torch.ones(1, device=dev))
            torch.cuda.synchronize()
            outcome = "accepted"
        except Exception as e:  # noqa: BLE001 — the outcome is reported
            outcome = f"refused: {type(e).__name__}: " + " ".join(
                ln for ln in str(e).splitlines() if "Duplicate" in ln
                or "invalid usage" in ln)[:300]
        with open(os.path.join(out, f"nccl{rank}.json"), "w") as f:
            json.dump(dict(outcome=outcome), f)
        return
    from torch.distributed.device_mesh import init_device_mesh

    from gnnla_tpu_torch.parallel import collectives
    from gnnla_tpu_torch.ops.stream_op import stream_operator
    initialize_distributed(f"file://{store}", 2, rank, device=dev,
                           backend="gloo", timeout=120)
    mesh = global_row_mesh(device_type="cuda")
    A = laplacian_2d(DIST_2RANK_N, device=dev).eliminate_zeros()
    rows, cols, vals = A.host_coo()
    new = np.argsort(np.random.default_rng(0).permutation(A.n_rows))
    A_p = SparseOperator.from_coo(new[rows], new[cols], vals, A.shape,
                                  device=dev)
    n = A_p.n_rows
    gen = np.random.default_rng(29)
    x_h = gen.standard_normal(n).astype(np.float32)
    x = torch.from_numpy(x_h).to(dev)
    res = {}
    part = partition_rows(A_p, 2)
    y = unshard_vector(gather_vector(make_sharded_matvec(part, mesh)(
        local_block(shard_vector(x, part), mesh)), mesh), part)
    res["coo_matvec"] = within(y, A_p.matvec(x), 1e-5, 1e-5, "COO matvec")
    kern = build_sharded_stream(A_p, mesh)
    y = torch.from_numpy(kern.matvec(x_h)).to(dev)
    want = stream_operator(A_p).matvec(x)
    res["stream_spmv"] = within(y, want, 2e-5,
                                2e-5 * float(want.abs().max()), "K2 shards")
    res["h_tiles"] = kern.h_tiles
    res["k2_launches"] = kern.fwd.launches
    setup = setup_twogrid(A_p, theta=0.25, splitting="cljp", seed=0)
    b = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(dev)
    cycle, vk = make_sharded_stream_vcycle(setup, mesh)
    b_l = vk.shard(vk.to_padded(b))
    x_l = torch.zeros_like(b_l)
    for _ in range(3):
        x_l = cycle(b_l, x_l)
    x_st = torch.from_numpy(vk.from_padded(vk.gather(x_l))).to(dev)
    x_ref = solve(setup, b, torch.zeros(n, device=dev), n_cycles=3)
    res["stream_vcycles"] = within(x_st, x_ref, 2e-4,
                                   2e-4 * float(x_ref.abs().max()),
                                   "3 V-cycles on K2 shards")
    cfg = TrainJacobiConfig(num_matrices=16, n_mesh=10, epochs=2,
                            batch_size=8, n_train=12, n_val=2, n_test=2,
                            m_probes=8, cache_dir=None, log_every=0)
    data = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
    _, h2 = train(cfg, mesh=data)
    _, h1 = train(cfg)
    res["jacobi_steps"] = within(
        torch.tensor(h2["train_loss"] + h2["val_loss"]),
        torch.tensor(h1["train_loss"] + h1["val_loss"]), 1e-5, 0.0,
        "2 data-parallel Jacobi steps")
    res["staged_transfers"] = collectives.staged_transfers
    with open(os.path.join(out, f"gloo{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def dist_2rank(smi) -> None:
    """Phase 40: two processes on the one card. The gloo pair's checks
    (`dist_rank`), correctness only; beside them a NCCL pair asks whether
    NCCL takes two ranks on one device."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctxs = {be: mp.start_processes(
            dist_rank, args=(os.path.join(tmp, f"store-{be}"), tmp, be),
            nprocs=2, join=False, start_method="spawn")
            for be in ("gloo", "nccl")}
        errors = join_spawned(ctxs, DIST_2RANK_TIMEOUT_S)
        require("gloo" not in errors, errors)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"gloo{r}.json")) as f:
                ranks.append(json.load(f))
        nccl = []
        for r in range(2):
            path = os.path.join(tmp, f"nccl{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    nccl.append(json.load(f)["outcome"])
    staged = all(r["staged_transfers"] > 0 for r in ranks)
    require(staged, "gloo moved no card tensor through the host")
    emit(dict(phase="dist_2rank", backend="gloo", world_size=2, card=0,
              staged_through_host=staged, ranks=ranks,
              nccl_two_ranks_one_card=nccl or errors.get("nccl"),
              seconds=time.perf_counter() - t0, nvidia_smi=smi))


def dist_phases(A, A_p, b, lib, flush, smi) -> list:
    """Phases 34-41 (distribution); returns the K2 shard rows."""
    with tempfile.TemporaryDirectory() as store:
        mesh = dist_init(os.path.join(store, "rendezvous"), smi)
        try:
            dist_spmv(A, mesh, smi)
            rows = dist_stream(A_p, mesh, lib, flush, smi)
            dist_vcycle(SHARED.pop("setup_p"), mesh, rows[0], smi)
            dist_mgpcg(A, b, mesh, smi)
            dist_train(smi)
            dist_2rank(smi)
            t0 = time.perf_counter()
            hw = run_sharded_hardware_check(device="cuda")
            require(hw["ok"], hw)
            emit(dict(phase="hw_check", seconds=time.perf_counter() - t0,
                      **hw, nvidia_smi=smi))
        finally:
            dist.destroy_process_group()
    return rows


# ------------------------------------------------------ the scratch twins
def scratch_fixtures(smi) -> dict:
    """The two 1,048,576-point fixtures of phases 42-46, built once: the
    Delaunay Laplacian (natural order; proto_ellw.py's points, seed 7, and
    the generator that then draws x) and the k-NN-32 Laplacian as
    bench_stream.py orders it."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    lap = proto_ellw.delaunay_laplacian(SCRATCH_N, rng)
    t_del = time.perf_counter() - t0
    t0 = time.perf_counter()
    knn = bench_stream.fixture(SCRATCH_N)
    t_knn = time.perf_counter() - t0
    emit(dict(phase="scratch_fixtures", n=SCRATCH_N, delaunay_s=t_del,
              delaunay_nnz=lap.nnz, knn_s=t_knn, knn_nnz=knn.nnz,
              nvidia_smi=smi))
    return dict(delaunay=lap, rng=rng, knn=knn)


def nonfinite_x(x: torch.Tensor, first: np.ndarray, seed: int
                ) -> torch.Tensor:
    """x with +inf, -inf and NaN each at 5 rows' first columns (which
    every padded slot of those rows reads) and at 5 other places."""
    out = x.cpu().numpy().copy()
    gen = np.random.default_rng(seed)
    for value in (np.inf, -np.inf, np.nan):
        out[first[gen.integers(0, first.size, 5)]] = value
        out[gen.integers(0, out.size, 5)] = value
    return torch.from_numpy(out).to(x.device)


def same_nonfinite(got: torch.Tensor, want: torch.Tensor, what) -> None:
    """got has want's NaNs where want has them and want's values (inf
    included) everywhere else."""
    nan = torch.isnan(want)
    require(bool(nan.any()) and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]), what)


def ellw_row(name: str, op, x, first: np.ndarray, k2, lib, flush,
             rel_err: float) -> dict:
    """K6's row on the layout `op`, whose twin's run made its launches, and
    x: the kernel (raw, uncounted) bitwise its plain version, on x and on
    x with inf and NaN; in its other window path where W fits a block and
    in the earlier full-slot body, each bitwise too; all of them, K2 on the
    same CSR `k2` and cuSPARSE timed in turns, L2 flushed. The bound is
    that of the slots the extents read; the whole layout's and the
    nonzeros' are beside it."""
    require(op.launches == 2 + SCRATCH_ITERS, (name, op.launches))
    want = op.plain(x)
    got = op.raw(x)[:op.n]
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"K6[{name}] is not its plain version")
    x_bad = nonfinite_x(x, first, 11)
    same_nonfinite(op.raw(x_bad)[:op.n], op.plain(x_bad),
                   f"K6[{name}] on x with inf and NaN")
    shared = op.path == "shared"

    def launch(on_shared: bool, seg=None):
        return lambda: ellw_cuda(op.idx, op.val, op.start, x, op.W,
                                 on_shared, seg)
    fns = {"kernel": lambda: op.raw(x),
           "earlier": launch(op.W * 4 <= EARLIER_SMEM_BYTES)}
    if op.W * 4 <= BLOCK_SMEM_MAX:
        fns["other_path"] = launch(not shared, op.seg)
    for key, fn in fns.items():
        require(torch.equal(fn()[:op.n], want), f"K6[{name}] {key}")
    raw_k2, _, _ = csr_raw(lib, k2, x)
    mat = csr_tensor(k2)
    compare(mat @ x, want, f"cuSPARSE beside K6[{name}]")
    fns.update(k2=raw_k2, library=lambda: mat @ x)
    ms = cold_ms_turns(fns, 20, flush)
    xy = op.n * 4 + op.n_tiles * 1024 * 4 + op.start.numel() * 4
    slots = op.idx.numel()
    read = 1024 * op.slots_read
    bound_ms, bound_by = bound(read * 8 + xy + op.seg.numel() * 4, 2 * read)
    return dict(
        name=f"ellw_spmv[{name}]", route="cuda", source=K6_ROW[0],
        replaces=K6_ROW[1], launches=op.launches,
        max_abs_err=float((got - want).abs().max()),
        ms=ms["kernel"], plain_ms=cuda_ms_cold(lambda: op.plain(x), 5, flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=ms["library"],
        earlier_ms=ms["earlier"],
        other_path_ms=ms.get("other_path"), k2_ms=ms["k2"], path=op.path,
        K=op.K, W=op.W, tiles=op.n_tiles, nnz=op.nnz,
        mean_slots_read=op.slots_read / op.n_tiles,
        padding_waste=op.padding_waste, read_waste=op.read_waste,
        layout_bound_ms=bound(slots * 8 + xy, 2 * slots)[0],
        nnz_floor_ms=bound(op.nnz * 8 + 2 * op.n * 4, 2 * op.nnz)[0],
        rel_err_vs_scipy=rel_err)


def ellw_on(name: str, res: dict, A_host, lib, flush) -> dict:
    """K6's row for the twin's run `res` on the scipy CSR A_host, K2 on
    the same CSR beside it."""
    k2 = CsrSpMV(A_host, device=res["x"].device)
    return ellw_row(name, res["op"], res["x"],
                    A_host.indices[A_host.indptr[:-1]], k2, lib, flush,
                    res["rel_err"])


def scratch_ellw(fx, dev, lib, flush, smi) -> list:
    """Phase 42: K6 at the script's default size, on the 1M Delaunay
    Laplacian in its RCM order and on the k-NN-32 Laplacian."""
    rows, t0 = [], time.perf_counter()
    res = proto_ellw.main([])  # the script's own fixture, n = 16,384
    rng = np.random.default_rng(7)
    small = proto_ellw.rcm_ordered(proto_ellw.delaunay_laplacian(
        proto_ellw.N_DEFAULT, rng))
    rows.append(ellw_on("delaunay_16K", res, small, lib, flush))
    d_rcm = proto_ellw.rcm_ordered(fx["delaunay"])
    x = fx["rng"].standard_normal(SCRATCH_N).astype(np.float32)
    res = proto_ellw.run(d_rcm, x, dev)
    rows.append(ellw_on("delaunay_1M", res, d_rcm, lib, flush))
    x = np.random.default_rng(0).standard_normal(SCRATCH_N).astype(
        np.float32)
    res = proto_ellw.run(fx["knn"], x, dev)
    rows.append(ellw_on("knn32_1M", res, fx["knn"], lib, flush))
    emit(dict(phase="scratch_ellw", seconds=time.perf_counter() - t0,
              smem_budget_bytes=ELLW_SMEM_BYTES,
              rows=[{k: r[k] for k in (
                  "name", "path", "K", "W", "tiles", "nnz", "mean_slots_read",
                  "padding_waste", "read_waste", "ms", "earlier_ms",
                  "other_path_ms", "k2_ms", "library_ms", "bound_ms",
                  "layout_bound_ms", "rel_err_vs_scipy")}
                  for r in rows],
              nvidia_smi=smi))
    return rows


def gather_row(kind: str, res: dict, launches: int, flush) -> dict:
    """A K7 (`axis1`) or K8 (`axis0`) row: the raw launch bitwise the
    plain version, flushed times, the bytes bound, the library call."""
    args = res["args"]
    if kind == "axis1":
        raw, plain = (lambda: axis1_cuda(*args)), (lambda: axis1_plain(*args))
        win, lo, hi, vals = args
        name, (src, rep) = f"gather_axis1[W={res['W']}]", K7_ROW
        idx = (hi.long() * 128 + lo.long())
        two = cuda_ms_cold(lambda: torch.take(win, idx) * vals, 20, flush)
        require(torch.equal(torch.take(win, idx) * vals, plain()),
                "take * vals differs from K7's plain version")
        lib_ms, extra = None, dict(library_two_calls_ms=two,
                                   library_two_calls="torch.take(win, idx) "
                                   "* vals (idx = 128 hi + lo, made once)")
        bytes_moved = 16 * vals.numel() + win.numel() * 4
        flops = vals.numel()
    else:
        raw, plain = (lambda: axis0_cuda(*args)), (lambda: axis0_plain(*args))
        win, idx = args
        R = win.shape[0]
        name, (src, rep) = f"gather_axis0[R={R}]", K8_ROW
        idx2 = idx.long().view(-1, 128)
        require(torch.equal(torch.gather(win, 0, idx2).view(idx.shape),
                            plain()), "torch.gather differs from K8's plain")
        # the earlier design, in the path it took, bitwise too; in turns
        # with the kernel and torch.gather
        earlier_path = ("window" if R * 128 * 4 <= EARLIER_SMEM_BYTES
                        else "read-only cache")
        require(res["path"] == axis0_path(R) == "slab", res["path"])
        require(torch.equal(axis0_cuda(*args, path=earlier_path), plain()),
                f"{name}: the earlier design is not the plain version")
        fns = {"kernel": raw,
               "earlier": lambda: axis0_cuda(*args, path=earlier_path),
               "library": lambda: torch.gather(win, 0, idx2)}
        t = cold_ms_turns(fns, 20, flush)
        lib_ms = t["library"]
        extra = dict(path=res["path"], earlier_ms=t["earlier"],
                     earlier_path=earlier_path)
        bytes_moved = 8 * idx.numel() + win.numel() * 4
        flops = 0
    got, want = raw(), plain()
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"{name} is not its plain version")
    bound_ms, bound_by = bound(bytes_moved, flops)
    ms = cuda_ms_cold(raw, 20, flush) if kind == "axis1" else t["kernel"]
    return dict(name=name, route="cuda", source=src, replaces=rep,
                launches=launches, max_abs_err=float((got - want).abs().max()),
                ms=ms, plain_ms=cuda_ms_cold(plain, 5, flush),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                elements=got.numel(), per_s_flushed=got.numel() / (ms * 1e-3),
                per_s_warm=res["per_s"], **extra)


def scratch_gather(dev, flush, smi) -> list:
    """Phase 43: the gather probes at probe_dyngather.py's sizes, then
    probe_gather's formulations at n = 1M."""
    t0 = time.perf_counter()
    probe = GatherProbe()
    rows = []
    for kind, kw in (("axis0", dict(R=8, n_blocks=512)),
                     ("axis0", dict(R=512, n_blocks=64)),
                     ("axis1", dict(n_chunks=8)), ("axis1", dict(n_chunks=16)),
                     ("axis1", dict(n_chunks=32))):
        before = probe.launches[kind]
        fn = (probe_dyngather.probe_axis0 if kind == "axis0"
              else probe_dyngather.probe_axis1)
        res = fn(dev, probe=probe, **kw)
        launches = probe.launches[kind] - before
        require(launches == 2 + SCRATCH_ITERS, (kind, kw, launches))
        rows.append(gather_row(kind, res, launches, flush))
        del res
    forms = probe_gather.run(SCRATCH_N, dev)
    emit(dict(phase="scratch_gather", seconds=time.perf_counter() - t0,
              launches=probe.launches,
              probes=[{k: r.get(k) for k in (
                  "name", "path", "ms", "earlier_ms", "per_s_flushed",
                  "per_s_warm", "bound_ms", "library_ms")} for r in rows],
              probe_gather=forms, nvidia_smi=smi))
    return rows


def scratch_stream_probe(dev, lib, flush, smi) -> dict:
    """Phase 44: probe_stream's fixture on K6 and K2."""
    out = probe_stream.run(dev)
    ell, csr, x = out["ell"], out["csr"], out["x"]
    require(ell.launches == csr.launches == 2 + SCRATCH_ITERS,
            (ell.launches, csr.launches))
    row = ellw_row("stream_probe", ell, x, probe_stream.fixture()[0][:, 0],
                   csr, lib, flush, out["K6"]["rel_err"])
    row["replaces_also"] = ("scratch/probe_stream.py:184 (main; kernel2 "
                            ":106): the same function, no kernel of its own")
    emit(dict(phase="scratch_stream_probe", K=ell.K, W=ell.W,
              rel_err_k6=out["K6"]["rel_err"], rel_err_k2=out["K2"]["rel_err"],
              k2_launches=csr.launches, row=row, nvidia_smi=smi))
    return row


def scratch_ablate(fx, dev, lib, flush, smi) -> list:
    """Phase 45: K9's variants on the ablation's operator."""
    t0 = time.perf_counter()
    A = ablate_stream.fixture(fx["delaunay"])
    t_fix = time.perf_counter() - t0
    out = ablate_stream.run(A, dev, iters=ABLATE_ITERS, flush=flush)
    abl, k2, x = out["ablation"], out["k2"], out["x"]
    mat = csr_tensor(k2)
    lib_ms = cuda_ms_cold(lambda: mat @ x, 20, flush)
    rows = []
    for v in VARIANTS:
        require(abl.launches[v] == 3 + 2 * ABLATE_ITERS, (v, abl.launches))
        got, want = abl.raw(v, x), abl.plain(v, x)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K9[{v}] is not its plain version")
        r = out["variants"][v]
        # a multiply or add and an add a nonzero; noscan's one product
        bound_ms, bound_by = bound(variant_bytes(k2, v),
                                   k2.nnz * (1 if v == "noscan" else 2))
        computes_ax = v in ("full", "nomatmul", "nodeposit")
        rows.append(dict(
            name=f"csr_ablate[{v}]", route="cuda", source=K9_ROW[0],
            replaces=K9_ROW[1], launches=abl.launches[v],
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms_cold(lambda: abl.raw(v, x), 20, flush),
            plain_ms=cuda_ms_cold(lambda: abl.plain(v, x), 3, flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms if computes_ax else None,
            ms_warm=r["ms_warm"], ms_flushed_twin=r["ms_flushed"],
            stage_ms_warm=r.get("stage_ms_warm"),
            stage_ms_flushed=r.get("stage_ms_flushed"),
            dropped=ablate_stream.DROPPED.get(v)))
    # the same variants on the stream leg's A_rcm (phase 12), the grid's
    # operator: raw launches, uncounted
    a_rcm = SHARED.pop("a_rcm_k2")
    abl_g = StreamAblation(a_rcm)
    x_g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        a_rcm.shape[1]).astype(np.float32)).to(x.device)
    grid = {}
    for v in VARIANTS:
        got = abl_g.raw(v, x_g)
        require(torch.equal(got, abl_g.plain(v, x_g)), f"K9[{v}] on A_rcm")
        grid[v] = dict(ms_flushed=cuda_ms_cold(lambda: abl_g.raw(v, x_g),
                                               ABLATE_ITERS, flush),
                       ms_warm=cuda_ms(lambda: abl_g.raw(v, x_g),
                                       iters=2 * ABLATE_ITERS))
    for v in VARIANTS[1:]:
        for key in ("flushed", "warm"):
            grid[v][f"stage_ms_{key}"] = (grid["full"][f"ms_{key}"]
                                          - grid[v][f"ms_{key}"])
    emit(dict(phase="scratch_ablate", fixture_s=t_fix, n=A.shape[0],
              nnz=A.nnz, row_blocks=k2.row_blocks.shape[0] - 1,
              full_bitwise_k2=True, variants=out["variants"],
              a_rcm=dict(n=a_rcm.shape[0], nnz=a_rcm.nnz,
                         row_blocks=a_rcm.row_blocks.shape[0] - 1,
                         variants=grid),
              nvidia_smi=smi))
    return rows


def scratch_bench_stream(fx, dev, lib, flush, smi) -> dict:
    """Phase 46: bench_stream on the k-NN-32 Laplacian; K2's row there."""
    t0 = time.perf_counter()
    out = bench_stream.run(fx["knn"], dev)
    mv, x = out["op"], out["x"]
    require(mv.launches == 2 + 6 * 100 and out["op_t"].launches == 1,
            (mv.launches, out["op_t"].launches))
    raw, bytes_moved, flops = csr_raw(lib, mv, x)
    mat = csr_tensor(mv)
    want = mv.plain(x)
    got = csr_spmv_cuda(mv.row_ptr, mv.cols, mv.vals, x, mv.shape[0],
                        mv.row_blocks)  # uncounted: a comparison
    err = compare(got, want, "K2 on the k-NN-32 Laplacian")
    bound_ms, bound_by = bound(bytes_moved, flops)
    row = dict(name="csr_spmv[knn32_rcm]", route="cuda", source=K2_ROW[1],
               replaces=K2_ROW[2], launches=mv.launches,
               max_abs_err=err["max_abs_err"],
               ms=cuda_ms_cold(raw, 20, flush),
               plain_ms=cuda_ms_cold(lambda: mv.plain(x), 5, flush),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=cuda_ms_cold(lambda: mat @ x, 20, flush),
               **k2_fields(mv))
    emit(dict(phase="scratch_bench_stream",
              seconds=time.perf_counter() - t0, n=fx["knn"].shape[0],
              nnz=fx["knn"].nnz, rel_err=out["rel_err"],
              rel_err_plain=out["rel_err_plain"],
              vjp_rel_err=out["vjp_rel_err"],
              edges_per_s=out["edges_per_s"],
              ms_per_apply_chained=out["ms_per_apply"],
              scipy_edges_per_s=out["scipy_edges_per_s"],
              ratio=out["ratio"], nvidia_smi=smi))
    return row


def scratch_phases(dev, lib, flush, smi) -> list:
    """Phases 42-46; returns their kernels rows."""
    fx = scratch_fixtures(smi)
    rows = scratch_ellw(fx, dev, lib, flush, smi)
    rows += scratch_gather(dev, flush, smi)
    rows.append(scratch_stream_probe(dev, lib, flush, smi))
    rows += scratch_ablate(fx, dev, lib, flush, smi)
    rows.append(scratch_bench_stream(fx, dev, lib, flush, smi))
    return rows


# ------------------------------------------------- the artifact pipelines
def quiet(fn, *args, **kw):
    """fn's result, its printed lines kept off this script's stdout."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def repro_jacobi(dev, smi, out_dir: str) -> None:
    """Phase 47: the reproduce_jacobi twin's pipeline, 2 epochs, on phase
    30's dataset; its six baselines against the committed results."""
    with open(os.path.join(ARTIFACT, "results.json")) as f:
        art = json.load(f)
    cfg = TrainJacobiConfig(epochs=REPRO_EPOCHS, loss_layout="dia",
                            cache_dir=None, log_every=0)
    t0 = time.perf_counter()
    res = quiet(reproduce_jacobi.pipeline, cfg, SHARED["jacobi_ds"],
                out_dir, dev)
    seconds = time.perf_counter() - t0
    gaps = {}
    for part in ("highfreq_damping_mean", "fullspectrum_damping_mean"):
        require(np.isfinite(res[part]["learned"]), res[part])
        for k in ("w1", "w23", "opt"):
            gaps[f"{part}.{k}"] = rel_gap(res[part][k], art[part][k])
            require(gaps[f"{part}.{k}"] <= BASELINE_RTOL,
                    (part, k, res[part][k], art[part][k]))
    require(res["n_test_matrices"] == 150, res["n_test_matrices"])
    with open(os.path.join(out_dir, "history.json")) as f:
        hist = json.load(f)
    require(bool(np.isfinite(hist["train_loss"] + hist["val_loss"]
                             + [hist["test_loss"]]).all()), hist)
    steps = cfg.n_train // cfg.batch_size
    emit(dict(phase="repro_jacobi", epochs=REPRO_EPOCHS, results=res,
              baseline_rel_gaps=gaps, history=hist,
              ms_per_step_with_probes=[1e3 * t / steps
                                       for t in hist["epoch_time_s"]],
              train_s=res["train_seconds"], seconds=seconds,
              nvidia_smi=smi))


def repro_smoother(dev, smi) -> None:
    """Phase 48: the two-grid closure on the committed parameters."""
    with open(os.path.join(ARTIFACT, "smoother_twogrid.json")) as f:
        art = json.load(f)
    cfg = smoother_twogrid.load_config(ARTIFACT)
    model, model_s = smoother_twogrid.load_models(ARTIFACT, cfg, dev)
    te = jacobi_test_split(SHARED["jacobi_ds"], cfg)
    t0 = time.perf_counter()
    out = quiet(smoother_twogrid.rho_table, te, model, model_s, 30)
    seconds = time.perf_counter() - t0
    gaps = {k: rel_gap(out[k], art[k])
            for k in ("convfac_w23_mean", "convfac_w23_max")}
    require(max(gaps.values()) <= RHO_W23_RTOL, (gaps, out))
    for k, want in (("convfac_learned_mean", JAX_CPU_CONVFAC_LEARNED_MEAN),
                    ("convfac_stable_mean", JAX_CPU_CONVFAC_STABLE_MEAN)):
        gaps[k] = rel_gap(out[k], want)
        require(gaps[k] <= RHO_LEARNED_RTOL, (k, out[k], want))
    emit(dict(phase="repro_smoother", results=out, rel_gaps=gaps,
              seconds=seconds, nvidia_smi=smi))


def repro_stable(dev, smi) -> None:
    """Phase 49: the stable fine-tune's configuration, 2 epochs from the
    committed reference-recipe parameters (full-spectrum damping 2.19, so
    the penalty is active from the first batch)."""
    ds = SHARED["jacobi_ds"]
    cfg = reproduce_jacobi_stable.stable_config(epochs=REPRO_EPOCHS)
    cfg.cache_dir, cfg.log_every = None, 0
    init = quiet(reproduce_jacobi_stable.warm_start, ARTIFACT)
    model = TrainableJacobiMLP(cfg.widths, cfg.init_scheme, device=dev)
    model.load_state_dict(init)
    loss_fn = make_loss_fn(model, ds, cfg.omega, cfg.gelfand_k,
                           stability_weight=cfg.stability_weight,
                           stability_margin=cfg.stability_margin,
                           stability_k=cfg.stability_k)
    part = ds.select(np.arange(cfg.batch_size))
    rng = np.random.default_rng(cfg.seed)
    args = [f32_on(a, dev) for a in (
        matrix_stack(part, "dia"), feature_stack(part), part.diags,
        _draw_probes(part, range(part.n_graphs), cfg.m_probes, rng))]
    full = f32_on(rng.standard_normal(
        (part.n_graphs, ds.template.n_rows, cfg.m_probes)), dev)
    with torch.no_grad():
        penalty = float(loss_fn(*args, full) - loss_fn(*args))
    require(penalty > 0, penalty)
    t0 = time.perf_counter()
    _, hist = quiet(train, cfg, dataset=ds, init_params=init, device=dev)
    seconds = time.perf_counter() - t0
    require(bool(np.isfinite(hist["train_loss"] + hist["val_loss"]
                             + [hist["test_loss"]]).all()), hist)
    emit(dict(phase="repro_stable", epochs=REPRO_EPOCHS,
              first_batch_penalty=penalty, history=hist, seconds=seconds,
              nvidia_smi=smi))


def repro_diffusion(dev, smi, out_dir: str) -> None:
    """Phase 50: the committed model through the twin's evaluation, then
    the twin's pipeline for 2 epochs on phase 26's dataset."""
    cfg = reproduce_diffusion.flagship_config(epochs=REPRO_EPOCHS)
    cfg.cache_dir, cfg.log_every = None, 0
    model = load_diffusion_params_npz(
        os.path.join(DIFF_ARTIFACT, "params.npz"),
        DiffusionGNN(**DIFF_CFG, device=dev))
    t0 = time.perf_counter()
    ood, freqs, errors = quiet(reproduce_diffusion.evaluate, model, cfg)
    eval_s = time.perf_counter() - t0
    gaps = {"ood": rel_gap(ood["loss"], JAX_CPU_OOD_LOSS),
            "freq": rel_gap(errors, JAX_CPU_FREQ_ERRORS)}
    require(max(gaps.values()) <= 1e-4, gaps)
    t0 = time.perf_counter()
    res = quiet(reproduce_diffusion.pipeline, cfg, SHARED["diffusion_full"],
                out_dir, dev)
    seconds = time.perf_counter() - t0
    require(res["epochs_run"] == REPRO_EPOCHS and all(np.isfinite(
        [res["test_loss"], res["freq_study_mean_err"],
         *res["ood_loss_by_decade"].values()])), res)
    emit(dict(phase="repro_diffusion", committed_rel_gaps_jax_cpu=gaps,
              committed_eval_s=eval_s, results=res, seconds=seconds,
              nvidia_smi=smi))


def repro_grid(dev, smi) -> None:
    """Phase 51: the five combinations at the grid's size, 2 epochs each."""
    t0 = time.perf_counter()
    ds = cosine_diffusion_dataset(300, n=48, max_freq=3.0, seed=41,
                                  cache_dir=None, device=dev)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = quiet(grid_diffusion.run_grid, ds, 300, 48, REPRO_EPOCHS, 12, dev)
    seconds = time.perf_counter() - t0
    vals = [c["val_loss"] for c in out["combos"]]
    require(len(vals) == 5 and all(np.isfinite(
        vals + [c["test_loss"] for c in out["combos"]])), out)
    require(out["best_index"] == int(np.argmin(vals)), out)
    emit(dict(phase="repro_grid", results=out, dataset_s=data_s,
              seconds=seconds, nvidia_smi=smi))


def dryrun_summary(res: dict) -> dict:
    return {k: res[k] for k in (
        "loss", "reference_loss", "loss_rel_gap", "param_max_abs_gap",
        "stencil_max_abs_err", "stream_max_abs_err",
        "stream_vcycle_max_abs_err", "mesh", "h_tiles", "k2_launches",
        "line")}


def dryrun_phase(dev, lib, flush, smi) -> dict:
    """Phase 52: the dry run as one call on two spawned gloo ranks sharing
    the card (`graft_entry.dryrun_multichip(2)`), and inside this
    process's world of one NCCL rank; returns the K2 row of the NCCL
    run's stream shard."""
    t0 = time.perf_counter()
    two = graft_entry.dryrun_multichip(2, timeout=DRYRUN_TIMEOUT_S)
    two_s = time.perf_counter() - t0
    require(tuple(two["mesh"]) == (2, 1) and two["line"].startswith(
        "dryrun_multichip(2): ") and two["backend"] == "gloo"
        and two["staged_transfers"] > 0, dryrun_summary(two))
    require(two["loss_rel_gap"] <= 1e-6 and two["param_max_abs_gap"]
            <= 1e-6, dryrun_summary(two))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        initialize_distributed(f"file://{os.path.join(store, 'rdv')}", 1, 0,
                               device="cuda")
        try:
            res = quiet(graft_entry.dryrun_multichip, 1)
        finally:
            dist.destroy_process_group()
    one_s = time.perf_counter() - t0
    require(res["loss_rel_gap"] <= 1e-6 and res["param_max_abs_gap"]
            <= 1e-6, dryrun_summary(res))
    # the path's K2 launches: the shards' objects are new in this run
    require(res["k2_launches"] > 0, res["k2_launches"])

    csr = res["stream_kernel"].fwd
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        csr.shape[1]).astype(np.float32)).to(dev)
    err = compare(csr(x), csr.plain(x), "dry run's K2 shard")
    raw, bytes_moved, flops = csr_raw(lib, csr, x)
    lib_mat = csr_tensor(csr)
    bound_ms, bound_by = bound(bytes_moved, flops)
    row = dict(name="csr_spmv[dryrun_stream_shard]", route="cuda",
               source=K2_ROW[1], replaces=K2_ROW[2],
               via="gnnla_tpu/parallel/stream.py:145",
               launches=res["k2_launches"], max_abs_err=err["max_abs_err"],
               ms=cuda_ms_cold(raw, 20, flush),
               plain_ms=cuda_ms_cold(lambda: csr.plain(x), 5, flush),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=cuda_ms_cold(lambda: lib_mat @ x, 20, flush),
               shape=list(csr.shape), nnz=csr.nnz, **k2_fields(csr))
    emit(dict(phase="dryrun", two_gloo_ranks=dict(
        dryrun_summary(two), backend=two["backend"],
        staged_transfers=two["staged_transfers"]), two_ranks_s=two_s,
              one_nccl_rank=dryrun_summary(res), one_rank_s=one_s,
              k2_row=row, nvidia_smi=smi))
    return row


def repro_phases(dev, lib, flush, smi) -> dict:
    """Phases 47-52; returns the dry run's K2 row."""
    with tempfile.TemporaryDirectory() as tmp:
        jdir, ddir = (os.path.join(tmp, d) for d in ("jacobi", "diffusion"))
        os.makedirs(jdir)
        os.makedirs(ddir)
        repro_jacobi(dev, smi, jdir)
        repro_smoother(dev, smi)
        repro_stable(dev, smi)
        repro_diffusion(dev, smi, ddir)
    del SHARED["diffusion_full"], SHARED["jacobi_ds"]
    repro_grid(dev, smi)
    return dryrun_phase(dev, lib, flush, smi)


def bench_twin(smi) -> list:
    """Phase 53: the bench twin in a subprocess on the card; returns its
    kernel rows (their launches are the run's)."""
    p, secs = run_module(["gnnla_tpu_torch.bench", *BENCH_ARGS],
                         BENCH_TIMEOUT_S)
    require(p.returncode == 0, (p.returncode, p.stderr[-6000:]))
    line = json.loads(p.stdout.strip().splitlines()[-1])
    extra = line["extra"]
    require(line["metric"] == "spmv_edges_per_s"
            and extra["sections_done"] == list(BENCH_DEFAULT_SECTIONS)
            and not extra.get("failed_sections")
            and not extra.get("skipped_sections"),
            (extra["sections_done"], extra.get("failed_sections"),
             extra.get("skipped_sections")))
    rates = {k: v for k, v in extra.items() if k.endswith("_edges_per_s")}
    require(rates and all(v is not None and np.isfinite(v) and v > 0
                          for v in rates.values()), rates)
    fracs = {k: v for k, v in extra.items() if k.endswith("_roofline_frac")}
    require(len(fracs) == 3 and all(v is not None and 0 < v <= 1.05
                                    for v in fracs.values()), fracs)
    errs = {k: extra[k] for k in BENCH_ERR_LIMITS}
    require(all(errs[k] < lim for k, lim in BENCH_ERR_LIMITS.items()), errs)
    require(np.isfinite(line["value"]) and line["value"] == max(
        extra[k] for k in ("coo_segment_edges_per_s",
                           "dia_shift_edges_per_s", "dia_pallas_edges_per_s",
                           "dia_pallas_bf16_edges_per_s",
                           "stencil_resident_edges_per_s")), line["value"])
    rows = extra["kernels"]
    require([r["name"] for r in rows] == list(BENCH_KERNEL_ROWS)
            and all(r["launches"] > 0 for r in rows),
            [(r["name"], r["launches"]) for r in rows])
    emit(dict(phase="bench_twin", argv=list(BENCH_ARGS), seconds=secs,
              value=line["value"], vs_baseline=line["vs_baseline"],
              device=extra["device"], rel_errs=errs, roofline_fracs=fracs,
              device_busy_vs_wall_ms={
                  r["name"]: dict(device_ms=r["device_ms"],
                                  wall_ms=r["wall_ms"], launches=r["launches"])
                  for r in rows},
              nvidia_smi=smi))
    return rows


def kernel_wrappers() -> list:
    """Every live K1, K2 and K4 wrapper (the objects whose counters move
    where they launch their kernels)."""
    kinds = (DiaKernelOperator, CsrSpMV, StencilCall, StencilSpMV)
    with warnings.catch_warnings():  # deprecated objects met on the heap
        warnings.simplefilter("ignore")
        return [o for o in gc.get_objects() if isinstance(o, kinds)]


def launch_counts(wrappers: list) -> list:
    return [tuple(getattr(o, a, 0) for a in ("launches", "launches_mm",
                                             "launches_t"))
            for o in wrappers]


def graft_entry_phase(smi) -> dict:
    """Phase 54: the entry contract's flagship cycle (`graft_entry.entry`)
    on the card against `entry("cpu")`, ten chained cycles, purity, times
    and the profiler's kernels; no hand-written kernel launches; then
    `python -m gnnla_tpu_torch.graft_entry`."""
    wrappers = kernel_wrappers()
    counts = launch_counts(wrappers)
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup, b, x = args
    require(type(setup.A) is DIAOperator and type(setup.Ac) is DIAOperator
            and type(setup.P) is SparseOperator,
            [type(op).__name__ for op in (setup.A, setup.Ac, setup.P)])
    fn_c, args_c = graft_entry.entry(device="cpu")
    require(torch.equal(b.cpu(), args_c[1])
            and torch.equal(x.cpu(), args_c[2]), "b, x differ from the CPU's")
    before = [t.clone() for t in (b, x, setup.A.diags, setup.Ac.diags,
                                  setup.P.vals, setup.diag)]
    y = fn(*args)
    y2 = fn(*args)
    torch.cuda.synchronize()
    # the COO P's index_add_ adds with atomics on the card, in no fixed
    # order: two calls agree within the tolerance, not bit for bit
    repeat = compare(y2, y, "a second call", rtol=ENTRY_RTOL)
    require(all(torch.equal(t0_, t1_) for t0_, t1_ in zip(before, (
        b, x, setup.A.diags, setup.Ac.diags, setup.P.vals, setup.diag))),
        "fn wrote into an argument")
    want = fn_c(*args_c)
    err = compare(y.cpu(), want, "entry() on the card against the CPU",
                  rtol=ENTRY_RTOL)
    res = [float(torch.linalg.vector_norm(b - setup.A.matvec(x)))]
    xi = x
    for _ in range(ENTRY_CHAINED):
        xi = fn(setup, b, xi)
        res.append(float(torch.linalg.vector_norm(b - setup.A.matvec(xi))))
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)

    ms = cuda_ms(lambda: fn(*args), iters=20)
    prof = profile_cycles(lambda c: [fn(*args) for _ in range(c)])
    busy = prof["device_busy_ms_per_cycle"]
    hand = [k for k in prof["kernel_names"] if HAND_KERNELS.search(k)]
    require(not hand, hand)
    require(launch_counts(wrappers) == counts,
            "a K1, K2 or K4 wrapper launched during the phase")
    held = {id(w) for w in wrappers}  # alive: their ids are theirs
    new = [o for o in kernel_wrappers() if id(o) not in held]
    require(all(c == (0, 0, 0) for c in launch_counts(new)),
            "a new K1, K2 or K4 wrapper launched during the phase")

    p, main_s = run_module(["gnnla_tpu_torch.graft_entry"], 120)
    m = re.search(r"^entry\(\) vcycle output norm: (\S+)$", p.stdout, re.M)
    require(p.returncode == 0 and m is not None,
            (p.returncode, p.stdout[-2000:], p.stderr[-4000:]))
    norm = float(torch.linalg.vector_norm(want))
    require(abs(float(m.group(1)) - norm) <= ENTRY_RTOL * norm,
            (m.group(1), norm))
    mp = re.search(r"^program\(fn\) vcycle output norm: (\S+)$", p.stdout,
                   re.M)
    require(mp is not None and abs(float(mp.group(1)) - norm)
            <= ENTRY_RTOL * norm, (p.stdout[-2000:], norm))
    emit(dict(phase="graft_entry", setup_s=setup_s, n=int(b.numel()),
              A_K=len(setup.A.offsets), Ac_K=len(setup.Ac.offsets),
              P_nnz=setup.P.nnz, rtol=ENTRY_RTOL, max_abs_err=err[
                  "max_abs_err"], max_rel_err=err["max_rel_err"],
              repeat_max_abs_diff=repeat["max_abs_err"],
              repeat_bitwise=bool(torch.equal(y, y2)),
              residual_norms=res, ms_per_call=ms,
              device_busy_ms_per_call=busy,
              kernels_per_call=prof["launches_per_cycle"],
              idle_share=1.0 - busy / ms,
              top_kernels_per_call=prof["top_kernels_per_cycle"],
              hand_written_launches=0, main_s=main_s,
              main_line=m.group(0), main_program_line=mp.group(0),
              nvidia_smi=smi))
    del wrappers, new


COUNT_ATTRS = ("launches", "launches_mm", "launches_t")


def zero_counts(wrappers: list) -> None:
    for w in wrappers:
        for attr in COUNT_ATTRS:
            if hasattr(w, attr):
                setattr(w, attr, 0)


def outputs(y) -> tuple:
    return y if isinstance(y, tuple) else (y,)


def program_path(name, run, prog, eager, args, kw, wrappers) -> tuple:
    """Phase 55's checks and times of one path: run(*args, **kw) the entry
    point a user calls, which runs the fresh program `prog` (so its first
    call here captures), and `eager` its body. Returns the path's record
    and each wrapper's counts over the replays."""
    def call():
        return run(*args, **kw)

    def plain():
        return eager(*args, **kw)

    zero_counts(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = plain()
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() - base
    per_call = launch_counts(wrappers)
    # two eager calls differ where atomics add (the COO P's index_add_):
    # the spread the replay's error stands beside
    again = outputs(plain())
    repeat = max(float((a - w).abs().max() / w.abs().max())
                 for a, w in zip(again, outputs(want)))
    del again
    require(name == "entry" or any(sum(c) for c in per_call),
            f"{name}: no K1, K2 or K4 launch in an eager call")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    call()  # the warm-up, then the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    peak_capture = torch.cuda.max_memory_allocated() - base
    got = call()  # a replay
    torch.cuda.synchronize()
    errs = [compare(g, w, f"{name}: replay against eager", rtol=PROGRAM_RTOL)
            for g, w in zip(outputs(got), outputs(want))]
    bitwise = all(torch.equal(g, w)
                  for g, w in zip(outputs(got), outputs(want)))
    # the path's run: every count 0 just before, read just after
    zero_counts(wrappers)
    for _ in range(PROGRAM_REPLAYS):
        call()
    torch.cuda.synchronize()
    counts = launch_counts(wrappers)
    require(counts == [tuple(PROGRAM_REPLAYS * v for v in c)
                       for c in per_call], f"{name}: launch counts")
    require((prog.captures, prog.replays) == (1, PROGRAM_REPLAYS + 1),
            (name, prog.captures, prog.replays))
    ms = cuda_ms(call, iters=PROGRAM_REPLAYS)
    ms_eager = cuda_ms(plain, iters=PROGRAM_REPLAYS)
    prof = profile_cycles(lambda c: [call() for _ in range(c)])
    prof_eager = profile_cycles(lambda c: [plain() for _ in range(c)])
    source = "replay" if prof["launches_per_cycle"] > 0 else "eager"
    busy = (prof if source == "replay" else prof_eager)[
        "device_busy_ms_per_cycle"]
    return dict(
        path=name, ms_per_call=ms, ms_per_call_eager=ms_eager,
        device_busy_ms=busy, device_busy_source=source,
        device_busy_ms_eager=prof_eager["device_busy_ms_per_cycle"],
        kernels_per_call_replay=prof["launches_per_cycle"],
        kernels_per_call_eager=prof_eager["launches_per_cycle"],
        idle_share=1.0 - busy / ms,
        idle_share_eager=1.0 - prof_eager["device_busy_ms_per_cycle"]
        / ms_eager,
        capture_s=capture_s, peak_capture_bytes=peak_capture,
        peak_eager_bytes=peak_eager, bitwise=bitwise,
        max_abs_err=max(e["max_abs_err"] for e in errs),
        max_rel_err=max(e["max_rel_err"] for e in errs),
        eager_repeat_max_rel_err=repeat,
        hand_launches_per_call=sum(sum(c) for c in per_call),
        hand_launches_in_replays=sum(sum(c) for c in counts)), dict(
            zip(map(id, wrappers), counts))


def programs_phase(A, fast, b, smi) -> None:
    """Phase 55: seven paths as programs beside their eager bodies, and
    the K1 guard (see the module doc)."""
    n = A.n_rows
    x0 = torch.zeros(n, device=b.device)
    geo, auto, mg = SHARED.pop("geo"), SHARED.pop("auto"), SHARED.pop("mg")
    sv = auto._stencil
    # the geometric cycle on bf16 taps: its smoother is the K4 bf16 Jacobi
    # call of phase 8 (3 affine steps, omega 0.7, the tile form)
    geo16 = GeometricVCycle(A, (N_GRID, N_GRID), setup=geo.setup,
                            tap_dtype=torch.bfloat16)
    jac16 = geo16._pre._call
    require(jac16.taps.dtype == torch.bfloat16 and jac16.n_steps == 3
            and jac16.form.form == "tile", (jac16.taps.dtype, jac16.form))
    # fresh programs (earlier phases replayed these objects' own), so that
    # each path's first call here captures
    geo.program, sv.program = program(geo.cycle), program(sv.cycle)
    fn, entry_args = graft_entry.entry()
    progs = {name: program(f) for name, f in (
        ("entry", fn), ("fast_cycle", solve), ("amg_pcg", amg_pcg),
        ("mg_pcg", mg_pcg))}
    pcg = dict(flip_sign=True)
    paths = [  # name, entry point, its program, eager body, args, kwargs
        ("entry", progs["entry"], progs["entry"], fn, entry_args, {}),
        ("fast_cycle", progs["fast_cycle"], progs["fast_cycle"], solve,
         (fast, b, x0), dict(n_cycles=1)),
        ("auto_stencil", auto.run, sv.program, sv.cycle, (b, x0), {}),
        ("geometric", geo.run, geo.program, geo.cycle, (b, x0), {}),
        ("geometric_bf16", geo16.run, geo16.program, geo16.cycle, (b, x0),
         {}),
        ("amg_pcg", progs["amg_pcg"], progs["amg_pcg"], amg_pcg,
         (fast, b, x0), dict(n_iters=PROGRAM_AMG_PCG_ITERS, **pcg)),
        ("mg_pcg", progs["mg_pcg"], progs["mg_pcg"], mg_pcg, (mg, b, x0),
         dict(n_iters=PROGRAM_MG_PCG_ITERS, **pcg)),
    ]
    wrappers = kernel_wrappers()
    results, replay_counts = zip(*(program_path(*path, wrappers)
                                   for path in paths))
    jac16_launches = replay_counts[4][id(jac16)][0]
    require(jac16_launches == 2 * PROGRAM_REPLAYS, jac16_launches)
    for r, iters in zip(results[5:], (PROGRAM_AMG_PCG_ITERS,
                                      PROGRAM_MG_PCG_ITERS)):
        r.update(iterations=iters, ms_per_iteration=r["ms_per_call"] / iters,
                 ms_per_iteration_eager=r["ms_per_call_eager"] / iters)

    # the guard: an in-place update of A's diagonals (its values kept);
    # the profiled calls above captured the instrumented graph too
    run = progs["fast_cycle"]
    rebuilds, captures = fast.A.rebuilds, run.captures
    with torch.no_grad():
        fast.A.diags.mul_(1.0)
    y = run(fast, b, x0, n_cycles=1)
    torch.cuda.synchronize()
    require((run.captures, fast.A.rebuilds) == (captures + 1, rebuilds + 1),
            (run.captures, fast.A.rebuilds, rebuilds))
    want = solve(fast, b, x0, n_cycles=1)
    compare(y, want, "the recapture's warm-up", rtol=PROGRAM_RTOL)
    guard_err = compare(run(fast, b, x0, n_cycles=1), want,
                        "a replay of the new capture", rtol=PROGRAM_RTOL)
    require((run.captures, fast.A.rebuilds) == (captures + 1, rebuilds + 1),
            (run.captures, fast.A.rebuilds, rebuilds))
    emit(dict(phase="programs", rtol=PROGRAM_RTOL, replays=PROGRAM_REPLAYS,
              n=n, paths=results, k4_bf16_jacobi_launches=jac16_launches,
              guard=dict(captures=run.captures, k1_rebuilds_before=rebuilds,
                         k1_rebuilds_after=fast.A.rebuilds,
                         max_abs_err=guard_err["max_abs_err"]),
              nvidia_smi=smi))
    del wrappers


def main() -> int:
    # no cyclic-garbage collection pause may land inside a timed window;
    # reference counting still frees every tensor of this short run
    gc.disable()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    # the MLP and every reference run in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              cuda=torch.version.cuda, torch=torch.__version__,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
              nvidia_smi=smi))

    lib = _build.load(force=True)
    info = _build.build_info()
    probe = HealthCall()  # K5's launches on the build phase's probe
    probe_s = health_probe(dev, call=probe)
    k5_row = health_row(lib, probe.launches, flush=torch.ones(
        64 * 2 ** 20, device=dev))
    require(k5_row["launches"] == 1, k5_row)
    emit(dict(phase="build", seconds=info["seconds"], path=info["path"],
              ptxas=info["ptxas"], health_probe_s=probe_s, health=k5_row,
              nvidia_smi=smi))

    # ---------------------------------------------------------- setup
    t0 = time.perf_counter()
    A = laplacian_2d(N_GRID, device=dev).eliminate_zeros()
    plain = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = setup_with_stream_p(setup_with_dia(plain, kernel=True))
    t_swap = time.perf_counter() - t0
    require(isinstance(fast.A, DiaKernelOperator), type(fast.A))
    require(isinstance(fast.Ac, DiaKernelOperator), type(fast.Ac))
    require(isinstance(fast.P, RectStreamOperator), type(fast.P))
    n, nc = fast.P.shape
    # K1 reads Ac's compact layout: at most the pattern's nonzero
    # (32-row tile, diagonal) pairs, a small part of the dense 1,058 MB
    ac_tiles = fast.Ac.tiles
    require(ac_tiles.n_segs <= AC_SEGMENTS_MAX
            and ac_tiles.nbytes < AC_STORED_BYTES_MAX,
            (ac_tiles.n_segs, ac_tiles.nbytes))
    emit(dict(phase="setup", native_cljp=native_ext.available(),
              setup_twogrid_s=t_setup, swap_s=t_swap, n=n, nc=nc,
              A_nnz=A.nnz, A_K=len(fast.A.offsets), Ac_nnz=plain.Ac.nnz,
              Ac_K=len(fast.Ac.offsets),
              Ac_max_abs_offset=max(abs(o) for o in fast.Ac.offsets),
              Ac_segments=ac_tiles.n_segs, Ac_stored_bytes=ac_tiles.nbytes,
              Ac_dense_bytes=fast.Ac.diags.numel() * 4,
              Act_segments=fast.Ac.tiles_t.n_segs,
              Act_stored_bytes=fast.Ac.tiles_t.nbytes,
              P_nnz=fast.P.nnz))

    # ------------------------------------------- kernel vs plain version
    gen = np.random.default_rng(7)
    x_f = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(dev)
    x_c = torch.from_numpy(gen.standard_normal(nc).astype(np.float32)).to(dev)
    shapes = {  # name -> (wrapper, plain version, input)
        "A": (fast.A.matvec, fast.A.plain().matvec, x_f),
        "Ac": (fast.Ac.matvec, fast.Ac.plain().matvec, x_c),
        "P": (fast.P.fwd, fast.P.fwd.plain, x_c),
        "Pt": (fast.P.bwd, fast.P.bwd.plain, x_f),
    }
    errs = {}
    for key, (kern, ref, x) in shapes.items():
        got = kern(x)
        want = ref(x)
        torch.cuda.synchronize()
        errs[key] = compare(got, want, key)
        if key in ("P", "Pt"):  # K2: the CSR-order mul-then-add, bitwise
            errs[key]["bitwise_csr_order"] = bool(torch.equal(
                got, csr_sequential(kern, x[:, None])[:, 0]))
            require(errs[key]["bitwise_csr_order"], (key, errs[key]))
    emit(dict(phase="kernels", rtol=RTOL, atol=f"{RTOL} * max|y|",
              results=list(errs.values())))

    # ------------------------------------------------------- main path
    b = torch.from_numpy(
        np.random.default_rng(3).standard_normal(n).astype(np.float32)
    ).to(dev)
    x = torch.zeros(n, device=dev)
    counted = (fast.A, fast.Ac, fast.P.fwd, fast.P.bwd)
    for op in counted:
        op.launches = 0
    res = [float(torch.linalg.vector_norm(b - plain.A.matvec(x)))]
    for _ in range(N_CYCLES):
        x = solve(fast, b, x, n_cycles=1)
        # the plain COO A (index_add_) reads the residual: no kernel launch
        res.append(float(torch.linalg.vector_norm(b - plain.A.matvec(x))))
    torch.cuda.synchronize()
    launches = {"A": fast.A.launches, "Ac": fast.Ac.launches,
                "P": fast.P.fwd.launches, "Pt": fast.P.bwd.launches}
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)
    want_launches = {"A": 7 * N_CYCLES, "Ac": 4 * N_CYCLES,
                     "P": N_CYCLES, "Pt": N_CYCLES}
    require(launches == want_launches, (launches, want_launches))
    # no compaction inside a cycle: the layouts built at setup serve all
    rebuilds = {"A": fast.A.rebuilds, "Ac": fast.Ac.rebuilds}
    require(rebuilds == {"A": 0, "Ac": 0}, rebuilds)
    x_plain = solve(plain, b, torch.zeros(n, device=dev), n_cycles=N_CYCLES)
    require(x.shape == (n,) and bool(torch.isfinite(x).all()),
            "x must be finite, of shape [n]")
    rel = float((x - x_plain).abs().max() / x_plain.abs().max())
    require(rel <= 1e-4, rel)

    # small input: the card's kernel path against the port's CPU path
    A_s = laplacian_2d(64, device=dev).eliminate_zeros()
    small = setup_with_stream_p(setup_with_dia(setup_twogrid(A_s),
                                               kernel=True))
    A_h = laplacian_2d(64, device="cpu").eliminate_zeros()
    b_s = np.random.default_rng(5).standard_normal(A_s.n_rows).astype(
        np.float32)
    x_s = solve(small, torch.from_numpy(b_s).to(dev),
                torch.zeros(A_s.n_rows, device=dev), n_cycles=4).cpu()
    x_h = solve(setup_twogrid(A_h), torch.from_numpy(b_s),
                torch.zeros(A_s.n_rows), n_cycles=4)
    rel_small = float((x_s - x_h).abs().max() / x_h.abs().max())
    require(rel_small <= 2e-5, rel_small)
    emit(dict(phase="solve", cycles=N_CYCLES, residual_norms=res,
              launches=launches, k1_rebuilds=rebuilds,
              rel_err_vs_plain_path=rel,
              rel_err_64sq_vs_cpu=rel_small))

    # ----------------------------------------------------------- times
    torch.cuda.reset_peak_memory_stats()
    x0 = torch.zeros(n, device=dev)
    ms_cycle = cuda_ms(lambda: solve(fast, b, x0, n_cycles=1), iters=20)
    ms_cycle_plain = cuda_ms(lambda: solve(plain, b, x0, n_cycles=1),
                             iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    require(fast.A.rebuilds == fast.Ac.rebuilds == 0,
            "a K1 layout was rebuilt during the timed cycles")

    flush = torch.ones(64 * 2 ** 20, device=dev)  # 256 MB > the 50 MB L2
    kernels, warm, lib_errs = [], {}, {}
    for key, (kern, ref, xin) in shapes.items():
        extra = {}
        if key in ("A", "Ac"):
            op = getattr(fast, key)
            raw, bytes_moved, flops = dia_raw(lib, op.tiles, xin)
            kname, (src, rep) = "dia_spmv", K1_ROW
            lib_mat = csr_tensor(getattr(plain, key))
            extra = k1_fields(op.tiles, len(op.offsets), op.nnz)
        else:
            raw, bytes_moved, flops = csr_raw(lib, kern, xin)
            kname, src, rep = K2_ROW
            lib_mat = csr_tensor(kern)
            extra = k2_fields(kern)
        lib_errs[key] = compare(lib_mat @ xin, kern(xin),
                                f"cuSPARSE yardstick of {key}")
        bound_ms, bound_by = bound(bytes_moved, flops)
        kernels.append(dict(
            name=f"{kname}[{key}]", route="cuda", source=src, replaces=rep,
            launches=launches[key], max_abs_err=errs[key]["max_abs_err"],
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: ref(xin), 5, flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms_cold(lambda: lib_mat @ xin, 20, flush),
            **extra))
        # back to back, L2 warm: the wrapper (checks + launch) and the raw
        # launch it wraps; the gap between them is the wrapper's host cost
        warm[key] = dict(wrapper_ms=cuda_ms(lambda: kern(xin), iters=50),
                         raw_ms=cuda_ms(raw, iters=50),
                         launches_per_cycle=launches[key] // N_CYCLES)
    k1_ac = kernels[1]
    emit(dict(phase="times", ms_per_cycle=ms_cycle,
              ms_per_cycle_plain_path=ms_cycle_plain,
              k1_ac_ms=k1_ac["ms"], k1_ac_library_ms=k1_ac["library_ms"],
              k1_ac_below_library=k1_ac["ms"] < k1_ac["library_ms"],
              library_vs_kernel=lib_errs,
              kernel_ms_per_cycle=sum(
                  kk["ms"] * warm[key]["launches_per_cycle"]
                  for key, kk in zip(shapes, kernels)),
              l2_warm=warm, peak_mem_bytes=peak, nvidia_smi=smi))

    prof = profile_cycles(lambda c: solve(fast, b, x0, n_cycles=c))
    emit(dict(phase="profile", device_busy_ms_per_cycle=prof[
        "device_busy_ms_per_cycle"],
        idle_share=1.0 - prof["device_busy_ms_per_cycle"] / ms_cycle,
        top_kernels_per_cycle=prof["top_kernels_per_cycle"]))

    k4_rows, k4_off_path = grid_path(A, plain, b, x_plain, flush, smi)
    kernels += k4_rows
    k2_rows, A_p, S = stream_path(A, flush, smi)
    kernels += k2_rows
    kernels += stream_training(A_p, flush, smi)
    kernels += kernel_grads(A, plain, fast, flush, smi)
    kernels += multigrid_phases(A, plain, fast, b, flush, smi)
    kernels += sa_k2_phase(lib, flush, smi)
    # K4's normalize mode runs on the GN phases' path (the power method)
    (norm_row,) = [r for r in k4_off_path
                   if r["name"] == "stencil[power_normalize]"]
    gn_phases(A, plain, fast, b, x_plain, S, t_setup, norm_row, smi)
    kernels.append(norm_row)
    jacobi_weights(dev)
    train_phase(dev, smi)
    ds, te = diffusion_data(dev, smi)
    model = diffusion_serve(dev, ds, te, smi)
    diffusion_eval(dev, model, smi)
    diffusion_train(dev, ds, smi)
    SHARED["diffusion_full"] = ds  # phase 50 trains the twin on it
    del ds, te, model
    eigen_phase(dev, smi)
    bsr_phase(A_p, S, flush, smi)
    SHARED["a_rcm_k2"] = S.fwd  # K2 on A_rcm: phase 45 ablates it too
    del S
    torch.cuda.empty_cache()  # the subprocesses below share the card
    cli_examples_phases(smi)
    kernels += dist_phases(A, A_p, b, lib, flush, smi)
    del A_p
    torch.cuda.empty_cache()
    kernels += scratch_phases(dev, lib, flush, smi)
    kernels.append(repro_phases(dev, lib, flush, smi))
    torch.cuda.empty_cache()  # the twin's subprocess shares the card
    kernels += bench_twin(smi)
    graft_entry_phase(smi)
    programs_phase(A, fast, b, smi)
    kernels.append(k5_row)
    emit(dict(phase="script", seconds=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    # count: the cards visible to the process; the run drives card 0 only
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
