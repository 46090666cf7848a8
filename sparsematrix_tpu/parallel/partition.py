"""Multi-device partitioning of sparse matrices.

The reference has no distributed layer (SURVEY §2.4); this implements the
north-star capability: 1-D row partitioning (SpMV/SpMM) and column
partitioning (partial-product psum), designed for ``jax.sharding.Mesh`` +
``shard_map`` with XLA collectives.

Representation: per-shard local CSR arrays are **stacked on a leading device
axis** with equal static capacities, then sharded over that axis with
``PartitionSpec(axis_name)``.  Inside ``shard_map`` each device sees its own
(1, ...) slice.  Padding entries are harmless-by-construction (zero data,
in-range indices), so equalizing shard capacities costs no correctness.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..formats.base import register_sparse_pytree
from ..formats.csr import CSR

__all__ = ["PartitionedCSR", "partition_csr_rows", "partition_csr_cols"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """Row- or column-partitioned CSR, stacked on a leading shard axis.

    For ``axis="rows"``: shard i owns global rows [i*rows_per_shard, ...).
    For ``axis="cols"``: shard i owns global cols [i*cols_per_shard, ...),
    with local column indices rebased to the shard origin.
    """

    indptr: jnp.ndarray  # (n_shards, local_rows+1)
    indices: jnp.ndarray  # (n_shards, cap) — local (rebased) column ids
    data: jnp.ndarray  # (n_shards, cap)
    row_ids: jnp.ndarray  # (n_shards, cap) — local row ids (cap-padded w/ local_rows)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_shards: int = dataclasses.field(metadata={"static": True})
    partition_axis: str = dataclasses.field(metadata={"static": True})  # "rows"|"cols"
    local_rows: int = dataclasses.field(metadata={"static": True})
    local_cols: int = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def capacity(self) -> int:
        return self.indices.shape[1]

    def local_csr_arrays(self, shard_slice):
        """Given this pytree restricted to one shard (leading dim 1, as seen
        inside shard_map), return squeezed (indptr, indices, data, row_ids)."""
        return (
            shard_slice.indptr[0],
            shard_slice.indices[0],
            shard_slice.data[0],
            shard_slice.row_ids[0],
        )


def _pad_rows(sp, global_rows, padded_rows):
    indptr = sp.indptr
    if padded_rows > sp.shape[0]:
        indptr = np.concatenate(
            [indptr, np.full(padded_rows - sp.shape[0], indptr[-1], indptr.dtype)]
        )
    return indptr


def partition_csr_rows(csr: CSR, n_shards: int) -> PartitionedCSR:
    """Split a CSR into ``n_shards`` contiguous row bands of equal padded
    height; per-shard nnz padded to the max shard nnz (static capacity)."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_rows = -(-rows // n_shards)
    indptr_full = _pad_rows(sp, rows, local_rows * n_shards)
    caps = []
    shards = []
    for s in range(n_shards):
        r0, r1 = s * local_rows, (s + 1) * local_rows
        lo, hi = indptr_full[r0], indptr_full[r1]
        caps.append(int(hi - lo))
        shards.append((r0, int(lo), int(hi)))
    cap = max(max(caps), 1)
    n_indptr = np.zeros((n_shards, local_rows + 1), dtype=np.int64)
    n_indices = np.zeros((n_shards, cap), dtype=np.int64)
    n_data = np.zeros((n_shards, cap), dtype=sp.data.dtype)
    n_rowids = np.full((n_shards, cap), local_rows, dtype=np.int64)
    for s, (r0, lo, hi) in enumerate(shards):
        n_indptr[s] = indptr_full[r0 : r0 + local_rows + 1] - lo
        k = hi - lo
        n_indices[s, :k] = sp.indices[lo:hi]
        n_data[s, :k] = sp.data[lo:hi]
        counts = np.diff(n_indptr[s])
        n_rowids[s, :k] = np.repeat(np.arange(local_rows), counts)
    idt = csr.indices.dtype
    return PartitionedCSR(
        indptr=jnp.asarray(n_indptr, idt),
        indices=jnp.asarray(n_indices, idt),
        data=jnp.asarray(n_data),
        row_ids=jnp.asarray(n_rowids, idt),
        shape=(rows, cols),
        n_shards=n_shards,
        partition_axis="rows",
        local_rows=local_rows,
        local_cols=cols,
        nnz=csr.nnz,
    )


def partition_csr_cols(csr: CSR, n_shards: int) -> PartitionedCSR:
    """Split a CSR into ``n_shards`` column bands; each shard stores the full
    row range with column indices rebased to its band origin.  SpMV over this
    layout produces per-shard partial sums reduced with ``psum``."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_cols = -(-cols // n_shards)
    shard_mats = []
    for s in range(n_shards):
        c0, c1 = s * local_cols, min((s + 1) * local_cols, cols)
        shard_mats.append(sp[:, c0:c1].tocsr())
    cap = max(max(int(m.nnz) for m in shard_mats), 1)
    n_indptr = np.zeros((n_shards, rows + 1), dtype=np.int64)
    n_indices = np.zeros((n_shards, cap), dtype=np.int64)
    n_data = np.zeros((n_shards, cap), dtype=sp.data.dtype)
    n_rowids = np.full((n_shards, cap), rows, dtype=np.int64)
    for s, m in enumerate(shard_mats):
        n_indptr[s] = m.indptr
        k = int(m.nnz)
        n_indices[s, :k] = m.indices
        n_data[s, :k] = m.data
        n_rowids[s, :k] = np.repeat(np.arange(rows), np.diff(m.indptr))
    idt = csr.indices.dtype
    return PartitionedCSR(
        indptr=jnp.asarray(n_indptr, idt),
        indices=jnp.asarray(n_indices, idt),
        data=jnp.asarray(n_data),
        row_ids=jnp.asarray(n_rowids, idt),
        shape=(rows, cols),
        n_shards=n_shards,
        partition_axis="cols",
        local_rows=rows,
        local_cols=local_cols,
        nnz=csr.nnz,
    )
