"""Distributed block-format SpMM: row-partitioned BlockedELL over a mesh.

Each device owns a band of block-rows (stacked on a leading shard axis);
the dense RHS is all-gathered and each device runs the local blocked-ELL
product (gathered blocks + one einsum).  This is the distributed face of
the framework's block SpMM path (SURVEY §7 phase D capability).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import BlockedELL
from ..formats.base import register_sparse_pytree

__all__ = ["PartitionedBlockedELL", "partition_bell_rows", "dist_spmm_bell"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class PartitionedBlockedELL:
    block_cols: jnp.ndarray  # (n_shards, local_nbr, M)
    blocks: jnp.ndarray  # (n_shards, local_nbr, M, bm, bk)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_shards: int = dataclasses.field(metadata={"static": True})
    local_nbr: int = dataclasses.field(metadata={"static": True})
    block_shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})


def partition_bell_rows(bell: BlockedELL, n_shards: int) -> PartitionedBlockedELL:
    nbr, M = bell.block_cols.shape
    bm, bk = bell.block_shape
    local_nbr = -(-nbr // n_shards)
    bc = np.zeros((n_shards, local_nbr, M), dtype=np.asarray(bell.block_cols).dtype)
    bl = np.zeros((n_shards, local_nbr, M, bm, bk),
                  dtype=np.asarray(bell.blocks).dtype)
    bc_np = np.asarray(bell.block_cols)
    # padded block slots may carry stale values at padded rows; blocks are 0
    bl_np = np.asarray(bell.blocks)
    for s in range(n_shards):
        r0 = s * local_nbr
        r1 = min((s + 1) * local_nbr, nbr)
        bc[s, : r1 - r0] = bc_np[r0:r1]
        bl[s, : r1 - r0] = bl_np[r0:r1]
    return PartitionedBlockedELL(
        block_cols=jnp.asarray(bc),
        blocks=jnp.asarray(bl),
        shape=bell.shape,
        n_shards=n_shards,
        local_nbr=local_nbr,
        block_shape=(bm, bk),
        nnz=bell.nnz,
    )


def shard_bell(part: PartitionedBlockedELL, mesh: Mesh, axis_name: str = "shard"):
    spec = NamedSharding(mesh, P(axis_name))
    return dataclasses.replace(
        part,
        block_cols=jax.device_put(part.block_cols, spec),
        blocks=jax.device_put(part.blocks, spec),
    )


def dist_spmm_bell(part: PartitionedBlockedELL, X, mesh: Mesh,
                   axis_name: str = "shard"):
    """``Y = A @ X`` with A row-partitioned BlockedELL, X row-sharded."""
    bm, bk = part.block_shape
    n = part.n_shards
    nbc = -(-part.shape[1] // bk)
    k = X.shape[1]
    rows_pad = -(-nbc * bk // n) * n
    Xp = jnp.zeros((rows_pad, k), X.dtype).at[: X.shape[0]].set(X)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name, None)),
        out_specs=P(axis_name, None),
    )
    def run(bc_local, bl_local, X_local):
        X_full = jax.lax.all_gather(X_local, axis_name, tiled=True)
        X_full = X_full[: nbc * bk]
        Xb = X_full.reshape(nbc, bk, k)
        gathered = Xb[bc_local[0]]  # (local_nbr, M, bk, k)
        from ..utils.precision import matmul_precision

        acc = jnp.einsum("rmij,rmjk->rik", bl_local[0], gathered,
                         precision=matmul_precision(bl_local.dtype))
        return acc.reshape(part.local_nbr * bm, k)

    Y = run(part.block_cols, part.blocks, Xp)
    return Y[: part.shape[0]]
