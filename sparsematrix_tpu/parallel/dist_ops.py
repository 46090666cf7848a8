"""Distributed SpMV / SpMM via ``shard_map`` over a device mesh.

1-D row partition: each device holds a row band of A and a band of x/X.
The RHS is all-gathered (the x-halo exchange of the north star),
then each device runs its local CSR kernel — compute and XLA's collective
scheduling overlap automatically under ``jit``.

Column partition: each device holds a column band with rebased indices and
the matching x band; local products are partial sums reduced with ``psum``
(or ``psum_scatter`` to keep the output sharded).

The reference has no distributed layer (SURVEY §2.4); these are built on
XLA collectives (NCCL on the GPU) under ``shard_map``.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .partition import PartitionedCSR

__all__ = [
    "dist_spmv",
    "dist_spmm",
    "shard_partitioned",
    "make_mesh",
]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shard") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(devs[:n], (axis_name,))


def shard_partitioned(part: PartitionedCSR, mesh: Mesh, axis_name: str = "shard"):
    """Place a PartitionedCSR with its leading axis sharded over the mesh."""
    spec = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, spec), part)


def _local_spmv(indptr, indices, data, row_ids, x_full, local_rows):
    prod = data * x_full[indices]
    return jax.ops.segment_sum(prod, row_ids, num_segments=local_rows)


def _local_spmm(indptr, indices, data, row_ids, X_full, local_rows):
    prod = data[:, None] * X_full[indices]
    return jax.ops.segment_sum(prod, row_ids, num_segments=local_rows)


def dist_spmv(part: PartitionedCSR, x, mesh: Mesh, axis_name: str = "shard",
              reduce: str = "psum"):
    """``y = A @ x`` with A row- or column-partitioned over ``mesh``.

    Row partition: ``x`` enters sharded over its length (padded to
    n_shards * ceil(n / n_shards)); it is all-gathered on-device.  Output is
    sharded over rows.

    Column partition: ``x`` sharded by column band; partial products are
    reduced with ``reduce``:
      * ``"psum"`` — replicated output (each device holds all rows);
      * ``"psum_scatter"`` — the reduction stays sharded: device i ends up
        with row band i only, at 1/n_shards the psum output bytes (the
        ``reduce_scatter`` of the north-star checklist, SURVEY §2.4/§5).
    """
    n = part.n_shards
    if part.partition_axis == "rows":
        x_pad = _pad_vec(x, n * _band(part.shape[1], n))

        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name)),
            out_specs=P(axis_name),
        )
        def run(p_local, x_local):
            x_full = jax.lax.all_gather(x_local, axis_name, tiled=True)
            x_full = x_full[: part.shape[1]]
            ip, ix, dd, rid = part.local_csr_arrays(p_local)
            return _local_spmv(ip, ix, dd, rid, x_full, part.local_rows)

        y = run(part, x_pad)
        return y.reshape(-1)[: part.shape[0]]

    elif part.partition_axis == "cols":
        x_pad = _pad_vec(x, n * part.local_cols)
        rows_pad = n * _band(part.shape[0], n)

        if reduce == "psum":
            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name)),
                out_specs=P(None),
            )
            def run(p_local, x_local):
                ip, ix, dd, rid = part.local_csr_arrays(p_local)
                partial = _local_spmv(ip, ix, dd, rid, x_local,
                                      part.local_rows)
                return jax.lax.psum(partial, axis_name)

            return run(part, x_pad)[: part.shape[0]]

        if reduce == "psum_scatter":
            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name)),
                out_specs=P(axis_name),
            )
            def run(p_local, x_local):
                ip, ix, dd, rid = part.local_csr_arrays(p_local)
                partial = _local_spmv(ip, ix, dd, rid, x_local,
                                      part.local_rows)
                partial = jnp.zeros((rows_pad,), partial.dtype).at[
                    : part.local_rows].set(partial[: part.local_rows])
                # each device keeps its own reduced row band
                return jax.lax.psum_scatter(partial, axis_name,
                                            scatter_dimension=0, tiled=True)

            return run(part, x_pad).reshape(-1)[: part.shape[0]]
        raise ValueError(f"unknown reduce {reduce!r}")
    raise ValueError(part.partition_axis)


def dist_spmm(part: PartitionedCSR, X, mesh: Mesh, axis_name: str = "shard",
              reduce: str = "psum"):
    """``Y = A @ X`` with X dense (n × k).

    Row partition: X row-sharded by k-band, all-gathered on device; output
    row-sharded.  Column partition: X sharded to match A's column bands;
    per-device partial (m × k) products reduced with ``psum``
    (replicated Y) or ``psum_scatter`` (row-sharded Y).
    """
    n = part.n_shards
    k = X.shape[1]
    if part.partition_axis == "rows":
        Xp = _pad_mat(X, n * _band(part.shape[1], n))

        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name, None)),
            out_specs=P(axis_name, None),
        )
        def run(p_local, X_local):
            X_full = jax.lax.all_gather(X_local, axis_name, tiled=True)
            X_full = X_full[: part.shape[1]]
            ip, ix, dd, rid = part.local_csr_arrays(p_local)
            return _local_spmm(ip, ix, dd, rid, X_full, part.local_rows)

        Y = run(part, Xp)
        return Y[: part.shape[0]]

    elif part.partition_axis == "cols":
        Xp = _pad_mat(X, n * part.local_cols)
        rows_pad = n * _band(part.shape[0], n)

        if reduce == "psum":
            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name, None)),
                out_specs=P(None, None),
            )
            def run(p_local, X_local):
                ip, ix, dd, rid = part.local_csr_arrays(p_local)
                partial = _local_spmm(ip, ix, dd, rid, X_local,
                                      part.local_rows)
                return jax.lax.psum(partial, axis_name)

            return run(part, Xp)[: part.shape[0]]

        if reduce == "psum_scatter":
            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name, None)),
                out_specs=P(axis_name, None),
            )
            def run(p_local, X_local):
                ip, ix, dd, rid = part.local_csr_arrays(p_local)
                partial = _local_spmm(ip, ix, dd, rid, X_local,
                                      part.local_rows)
                partial = jnp.zeros((rows_pad, k), partial.dtype).at[
                    : part.local_rows].set(partial[: part.local_rows])
                return jax.lax.psum_scatter(partial, axis_name,
                                            scatter_dimension=0, tiled=True)

            return run(part, Xp)[: part.shape[0]]
        raise ValueError(f"unknown reduce {reduce!r}")
    raise ValueError(part.partition_axis)


def _band(total: int, n: int) -> int:
    return -(-total // n)


def _pad_vec(x, length: int):
    if x.shape[0] == length:
        return x
    return jnp.zeros((length,), x.dtype).at[: x.shape[0]].set(x)


def _pad_mat(X, length: int):
    if X.shape[0] == length:
        return X
    return jnp.zeros((length, X.shape[1]), X.dtype).at[: X.shape[0]].set(X)
