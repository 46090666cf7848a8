"""COO (coordinate) sparse format.

Arrays are padded to a static ``capacity``; padding entries carry
``row = col = 0`` and ``data = 0`` so they are harmless under accumulation
(the generalization of the reference's sentinel-zero filler,
reference src/sparse/sparse-matrix.cc:46-51).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, default_index_dtype, pad_to, register_sparse_pytree

__all__ = ["COO"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class COO(SparseFormat):
    row: jnp.ndarray  # (capacity,) int32
    col: jnp.ndarray  # (capacity,) int32
    data: jnp.ndarray  # (capacity,) value dtype
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    # -- construction ---------------------------------------------------
    @classmethod
    def fromdense(cls, dense, capacity: int | None = None, index_dtype=default_index_dtype):
        dense = np.asarray(dense)
        if dense.ndim != 2:
            raise ValueError("COO.fromdense expects a 2-D array")
        r, c = np.nonzero(dense)
        order = np.lexsort((c, r))  # row-major order
        r, c = r[order], c[order]
        vals = dense[r, c]
        return cls.from_arrays(r, c, vals, dense.shape, capacity, index_dtype)

    @classmethod
    def from_arrays(cls, row, col, data, shape, capacity: int | None = None,
                    index_dtype=default_index_dtype):
        row = np.asarray(row)
        col = np.asarray(col)
        data = np.asarray(data)
        nnz = int(row.shape[0])
        if capacity is None:
            capacity = nnz
        return cls(
            row=pad_to(jnp.asarray(row, dtype=index_dtype), capacity, 0),
            col=pad_to(jnp.asarray(col, dtype=index_dtype), capacity, 0),
            data=pad_to(jnp.asarray(data), capacity, 0),
            shape=(int(shape[0]), int(shape[1])),
            nnz=nnz,
        )

    @classmethod
    def from_scipy(cls, mat, capacity: int | None = None):
        coo = mat.tocoo()
        order = np.lexsort((coo.col, coo.row))
        return cls.from_arrays(coo.row[order], coo.col[order], coo.data[order],
                               coo.shape, capacity)

    # -- decode ---------------------------------------------------------
    def todense(self):
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        # scatter-add: padding rows/cols are (0, 0) with data 0, so harmless
        return out.at[self.row, self.col].add(self.data)

    def to_scipy(self):
        import scipy.sparse as sp

        r = np.asarray(self.row)[: self.nnz]
        c = np.asarray(self.col)[: self.nnz]
        d = np.asarray(self.data)[: self.nnz]
        return sp.coo_matrix((d, (r, c)), shape=self.shape)

    def transpose(self) -> "COO":
        """Logical transpose; entries re-sorted to row-major on host."""
        r = np.asarray(self.col)[: self.nnz]
        c = np.asarray(self.row)[: self.nnz]
        d = np.asarray(self.data)[: self.nnz]
        order = np.lexsort((c, r))
        return COO.from_arrays(r[order], c[order], d[order],
                               (self.shape[1], self.shape[0]), self.capacity)

    @property
    def T(self) -> "COO":
        return self.transpose()
