"""Distributed SpMM with PRE-DENSIFIED local bands (dense local compute).

``dist_spmm`` (dist_ops.py) runs an XLA gather+segment_sum as each device's
local compute.  For the densify-eligible regime (the same rule as
single-device ``spmm(auto)``: density ≥ ~5 %), the local compute can be
one dense contraction of a band materialized ONCE at partition time (the pre-dense
path, `Dense.from_sparse` analogue).  This module composes it with the
north-star collectives:

  * 1-D row partition (`dist_spmm_dense`): RHS all-gathered, local
    ``band @ X_full``, output row-sharded.
  * 2-D row×col mesh (`dist_spmm_dense_2d`): RHS column-panels gathered
    over the 'row' axis only, local ``band @ X_panel`` — the fast-local
    counterpart of ``dist_spmm_2d``.

The stacked-band representation follows the PartitionedCSR convention
(leading shard axis, equal static shapes; zero padding harmless).  The
reference has no distributed layer (SURVEY §2.4) — this is the
composition of its dense-fallback stance (kernel.cc's dense race) with
mesh collectives.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.base import register_sparse_pytree
from ..formats.csr import CSR
from ..utils.precision import matmul_precision

__all__ = ["PartitionedDense", "partition_dense_rows", "dist_spmm_dense",
           "dist_spmm_dense_2d", "shard_dense"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class PartitionedDense:
    bands: jnp.ndarray  # (n_shards, local_rows, cols_pad)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_shards: int = dataclasses.field(metadata={"static": True})
    local_rows: int = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})


def partition_dense_rows(csr: CSR, n_shards: int,
                         dtype=None) -> PartitionedDense:
    """Materialize per-shard dense row bands (host, encode-once).

    ``dtype=bfloat16`` stores the bands in bf16 — halves the memory
    traffic and runs the local product on the bf16 tensor cores.
    """
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_rows = -(-rows // n_shards)
    bands = np.zeros((n_shards, local_rows, cols), sp.dtype)
    for s in range(n_shards):
        r0, r1 = s * local_rows, min((s + 1) * local_rows, rows)
        if r0 < rows:
            bands[s, : r1 - r0] = sp[r0:r1].toarray()
    out = jnp.asarray(bands)
    if dtype is not None:
        out = out.astype(dtype)
    return PartitionedDense(
        bands=out,
        shape=(rows, cols),
        n_shards=n_shards,
        local_rows=local_rows,
        nnz=csr.nnz,
    )


def shard_dense(part: PartitionedDense, mesh: Mesh,
                axis_name: str = "shard"):
    spec = NamedSharding(mesh, P(axis_name))
    return dataclasses.replace(
        part, bands=jax.device_put(part.bands, spec))


def dist_spmm_dense(part: PartitionedDense, X, mesh: Mesh,
                    axis_name: str = "shard"):
    """``Y = A @ X`` with dense local bands; X row-sharded, Y row-sharded."""
    n = part.n_shards
    cols = part.shape[1]
    xb = -(-cols // n)
    k = X.shape[1]
    Xp = jnp.zeros((n * xb, k), X.dtype).at[: X.shape[0]].set(X)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name, None)),
        out_specs=P(axis_name, None),
    )
    def run(p_local, X_local):
        X_full = jax.lax.all_gather(X_local, axis_name, tiled=True)[:cols]
        band = p_local.bands[0]
        return jnp.dot(band, X_full.astype(band.dtype),
                       precision=matmul_precision(band.dtype))

    Y = run(part, Xp)
    return Y[: part.shape[0]]


def dist_spmm_dense_2d(part: PartitionedDense, X, mesh: Mesh):
    """``Y = A @ X`` on a ('row','col') mesh with dense local bands.

    A row-partitioned over 'row' (replicated over 'col'); X sharded
    (row, col); Y lands sharded (row, col) with no reduction — the
    fast-local counterpart of ``dist_spmm_2d``.
    """
    n_row = mesh.shape["row"]
    n_col = mesh.shape["col"]
    if part.n_shards != n_row:
        raise ValueError("partition count must match the mesh 'row' size")
    n = part.shape[1]
    k = X.shape[1]
    n_pad = n_row * (-(-n // n_row))
    k_pad = n_col * (-(-k // n_col))
    Xp = jnp.zeros((n_pad, k_pad), X.dtype).at[:n, :k].set(X)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("row"), P("row", "col")),
        out_specs=P("row", "col"),
    )
    def run(p_local, X_local):
        X_panel = jax.lax.all_gather(X_local, "row", tiled=True)[:n]
        band = p_local.bands[0]
        return jnp.dot(band, X_panel.astype(band.dtype),
                       precision=matmul_precision(band.dtype))

    Y = run(part, Xp)
    return Y[: part.shape[0], :k]
