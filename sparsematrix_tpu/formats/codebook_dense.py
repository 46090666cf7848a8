"""CodebookDense — dense uint8 index plane + value table.

The reference's format is primarily a *quantization* format (≤255 distinct
values, 2 bytes/entry stored); at its benchmark density (25%) the matrix is
not very sparse — zeros are just one more codebook entry.  The layout for
that regime is a **dense** uint8 index matrix (1 byte/element — still 4×
smaller than fp32) whose dequantization ``table[idx]`` is a vectorized
small-table gather that XLA compiles natively, feeding one dense product
— no scatter, no index streams.

``CodebookCSR`` remains the layout for genuinely sparse matrices; the two
cover the reference capability (sparse-matrix.h:26) across density regimes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, register_sparse_pytree

__all__ = ["CodebookDense"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class CodebookDense(SparseFormat):
    idx: jnp.ndarray  # (rows, cols) uint8 — table_size means zero
    val_table: jnp.ndarray  # (table_size+1,) with sentinel 0 appended
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})
    table_size: int = dataclasses.field(metadata={"static": True})

    @classmethod
    def from_index_matrix(cls, index_matrix, val_table, trans: bool = False):
        """Same encode semantics as CodebookCSR.from_index_matrix
        (CopyForm, sparse-matrix.cc:21-99): entries outside
        [0, table_size) denote zero and are remapped to the sentinel."""
        idx = np.asarray(index_matrix)
        table = np.asarray(val_table)
        ts = int(table.shape[0])
        if ts < 1 or ts > 255:
            raise ValueError("val_table size must be in [1, 255]")
        if trans:
            idx = idx.T
        valid = (idx >= 0) & (idx < ts)
        idx_u8 = np.where(valid, idx, ts).astype(np.uint8)
        table_ext = np.concatenate([table, np.zeros((1,), dtype=table.dtype)])
        return cls(
            idx=jnp.asarray(idx_u8),
            val_table=jnp.asarray(table_ext),
            shape=(int(idx.shape[0]), int(idx.shape[1])),
            nnz=int(valid.sum()),
            table_size=ts,
        )

    @property
    def data(self):
        raise AttributeError("CodebookDense stores a dense index plane")

    @property
    def dtype(self):
        return self.val_table.dtype

    def todense(self):
        # vectorized 256-entry LUT gather — no scatter
        return self.val_table[self.idx.astype(jnp.int32)]

    def transpose(self) -> "CodebookDense":
        return dataclasses.replace(
            self, idx=self.idx.T, shape=(self.shape[1], self.shape[0])
        )

    @property
    def T(self) -> "CodebookDense":
        return self.transpose()
