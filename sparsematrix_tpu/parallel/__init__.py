from .partition import PartitionedCSR, partition_csr_rows, partition_csr_cols
from .dist_ops import dist_spmv, dist_spmm, shard_partitioned, make_mesh
from .dist_dense import (
    PartitionedDense,
    partition_dense_rows,
    shard_dense,
    dist_spmm_dense,
    dist_spmm_dense_2d,
)
from .dist_block import (
    PartitionedBlockedELL,
    partition_bell_rows,
    shard_bell,
    dist_spmm_bell,
)
from .dist2d import make_mesh_2d, dist_spmm_2d
from .multihost import initialize_multihost, global_mesh
from .halo import (
    RingHaloCSR,
    partition_csr_halo_ring,
    dist_spmv_halo_ring,
    shard_halo_ring,
    HaloPartitionedCSR,
    VarHaloPartitionedCSR,
    partition_csr_halo,
    partition_csr_halo_var,
    dist_spmv_halo,
    dist_spmv_halo_var,
)
from .scaling import (
    CollectiveCost,
    halo_cost,
    spmm_col_cost,
    spmm_row_cost,
    spmv_col_cost,
    spmv_row_cost,
    weak_scaling_table,
)
from .halo import shard_halo
from .dist_solve import dist_bicgstab, dist_cg, dist_gmres
from .dist_precond import (ShardedPrecond, block_ic0_precond,
                           block_ilu0_precond)
from .dist_spgemm import (
    DistSpGEMMPlan,
    dist_spgemm_plan,
    dist_spgemm_apply,
    shard_dist_spgemm,
)

__all__ = [
    "PartitionedDense",
    "partition_dense_rows",
    "shard_dense",
    "dist_spmm_dense",
    "dist_spmm_dense_2d",
    "PartitionedCSR",
    "partition_csr_rows",
    "partition_csr_cols",
    "dist_spmv",
    "dist_spmm",
    "dist_bicgstab",
    "dist_cg",
    "ShardedPrecond",
    "block_ic0_precond",
    "block_ilu0_precond",
    "dist_gmres",
    "shard_partitioned",
    "make_mesh",
    "DistSpGEMMPlan",
    "dist_spgemm_plan",
    "dist_spgemm_apply",
    "shard_dist_spgemm",
    "PartitionedBlockedELL",
    "partition_bell_rows",
    "shard_bell",
    "dist_spmm_bell",
    "HaloPartitionedCSR",
    "VarHaloPartitionedCSR",
    "partition_csr_halo",
    "partition_csr_halo_ring",
    "dist_spmv_halo_ring",
    "shard_halo_ring",
    "RingHaloCSR",
    "partition_csr_halo_var",
    "dist_spmv_halo_var",
    "CollectiveCost",
    "spmv_row_cost",
    "spmv_col_cost",
    "spmm_row_cost",
    "spmm_col_cost",
    "halo_cost",
    "weak_scaling_table",
    "shard_halo",
    "dist_spmv_halo",
    "make_mesh_2d",
    "dist_spmm_2d",
    "initialize_multihost",
    "global_mesh",
]
