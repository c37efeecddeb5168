"""Distribution on `torch.distributed` — the counterpart of
gnnla_tpu/parallel/: row-partitioned SpMV, stencil and K2 (stream) paths,
the sharded two-grid and multilevel cycles, sharded mg_pcg, and the mesh
and data-path helpers. A mesh is a `DeviceMesh`; the collectives live in
`parallel/collectives.py`. Sharded functions take and return this rank's
local block (`local_block`, `gather_vector`)."""

from gnnla_tpu_torch.parallel.partition import (
    PartitionedOperator, partition_rows, shard_vector, unshard_vector)
from gnnla_tpu_torch.parallel.distributed import (
    device_put_sharded, gather_vector, global_row_mesh, grid_mesh,
    initialize_distributed, join_spawned, launched_ranks, local_block,
    mesh_device, replicate_global, spawn_ranks, to_global)
from gnnla_tpu_torch.parallel.krylov import make_sharded_mg_pcg
from gnnla_tpu_torch.parallel.vcycle import (make_sharded_multigrid_cycle,
                                             make_sharded_stream_vcycle,
                                             make_sharded_vcycle,
                                             partition_rows_rect)
from gnnla_tpu_torch.parallel.spmv import (
    make_sharded_matvec, make_sharded_jacobi, make_sharded_norm,
    make_sharded_power_method)
from gnnla_tpu_torch.parallel.stencil import (
    make_sharded_stencil_matvec, make_sharded_stencil_jacobi,
    shard_planes, shard_vec2d, stencil_scaling_model)
from gnnla_tpu_torch.parallel.stream import (ShardedStreamSpMV,
                                             build_sharded_stream,
                                             stream_scaling_model)

__all__ = ["PartitionedOperator", "partition_rows", "shard_vector",
           "unshard_vector", "make_sharded_matvec", "make_sharded_jacobi",
           "make_sharded_norm", "make_sharded_power_method", "device_put_sharded",
           "initialize_distributed", "global_row_mesh", "grid_mesh",
           "to_global", "replicate_global",
           "make_sharded_vcycle", "make_sharded_stream_vcycle",
           "make_sharded_multigrid_cycle", "make_sharded_mg_pcg",
           "partition_rows_rect",
           "make_sharded_stencil_matvec", "make_sharded_stencil_jacobi",
           "shard_planes", "shard_vec2d", "stencil_scaling_model",
           "ShardedStreamSpMV", "build_sharded_stream",
           "stream_scaling_model"]
