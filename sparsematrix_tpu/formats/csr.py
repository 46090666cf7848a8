"""CSR (compressed sparse row) format.

``indptr`` has static length ``rows + 1``; ``indices``/``data`` are padded to a
static capacity with in-range column 0 and value 0 (harmless padding — the
generalization of the reference's sentinel-zero entries,
reference src/sparse/sparse-matrix.cc:29-31).

``row_ids`` (the expanded per-entry row index, used by segment-sum SpMV) is
materialized lazily and cached on the host side via ``with_row_ids``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, default_index_dtype, pad_to, register_sparse_pytree

__all__ = ["CSR", "CSC"]


def _expand_rowids(indptr: np.ndarray, capacity: int, rows: int) -> np.ndarray:
    """Per-entry row id; padding entries get ``rows`` (dropped by segment_sum)."""
    counts = np.diff(indptr)
    ids = np.repeat(np.arange(rows, dtype=np.int64), counts)
    out = np.full((capacity,), rows, dtype=np.int64)
    out[: ids.shape[0]] = ids
    return out


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class CSR(SparseFormat):
    indptr: jnp.ndarray  # (rows+1,) int32
    indices: jnp.ndarray  # (capacity,) int32 column ids
    data: jnp.ndarray  # (capacity,)
    row_ids: Optional[jnp.ndarray]  # (capacity,) int32 or None
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    # -- construction ---------------------------------------------------
    @classmethod
    def from_arrays(cls, indptr, indices, data, shape, capacity: int | None = None,
                    index_dtype=default_index_dtype, with_row_ids: bool = True):
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        data = np.asarray(data)
        nnz = int(indptr[-1])
        if capacity is None:
            capacity = max(nnz, 1)
        rows = int(shape[0])
        row_ids = None
        if with_row_ids:
            row_ids = jnp.asarray(
                _expand_rowids(indptr, capacity, rows), dtype=index_dtype
            )
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=pad_to(jnp.asarray(indices, dtype=index_dtype), capacity, 0),
            data=pad_to(jnp.asarray(data), capacity, 0),
            row_ids=row_ids,
            shape=(rows, int(shape[1])),
            nnz=nnz,
        )

    @classmethod
    def fromdense(cls, dense, capacity: int | None = None, **kw):
        dense = np.asarray(dense)
        if dense.ndim != 2:
            raise ValueError("CSR.fromdense expects a 2-D array")
        rows, cols = dense.shape
        r, c = np.nonzero(dense)
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
        vals = dense[r, c]
        indptr = np.zeros(rows + 1, dtype=np.int64)
        np.add.at(indptr[1:], r, 1)
        indptr = np.cumsum(indptr)
        return cls.from_arrays(indptr, c, vals, dense.shape, capacity, **kw)

    @classmethod
    def from_scipy(cls, mat, capacity: int | None = None, **kw):
        csr = mat.tocsr()
        csr.sort_indices()
        out = cls.from_arrays(csr.indptr, csr.indices, csr.data, csr.shape,
                              capacity, **kw)
        # keep the host copy: to_scipy() would otherwise round-trip the
        # device arrays (hundreds of MB through the accelerator link at
        # the 10^7-nnz scale) on every pack/plan build
        object.__setattr__(out, "_host_scipy", csr)
        return out

    # -- decode ---------------------------------------------------------
    def _row_ids_or_compute(self):
        if self.row_ids is not None:
            return self.row_ids
        # traced fallback: searchsorted over indptr; padding entries land in
        # row `rows` which scatter/segment ops drop.
        pos = jnp.arange(self.capacity, dtype=self.indptr.dtype)
        return (
            jnp.searchsorted(self.indptr, pos, side="right").astype(self.indptr.dtype)
            - 1
        )

    def todense(self):
        rid = self._row_ids_or_compute()
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        # each stored slot is a distinct (row, col); padding rows land at
        # rid == rows and are dropped — so the scatter is unique-indexed,
        # which XLA can vectorize instead of serializing.
        return out.at[rid, self.indices].add(
            self.data, mode="drop", unique_indices=True
        )

    def to_scipy(self):
        import scipy.sparse as sp

        cached = getattr(self, "_host_scipy", None)
        if cached is not None:
            return cached
        out = sp.csr_matrix(
            (
                np.asarray(self.data)[: self.nnz],
                np.asarray(self.indices)[: self.nnz],
                np.asarray(self.indptr),
            ),
            shape=self.shape,
        )
        object.__setattr__(self, "_host_scipy", out)
        return out

    def transpose(self) -> "CSR":
        """Host-side transpose (build-time op, like the reference's
        ``SblasTrans`` encode-time transpose, sparse-matrix.cc:65-98)."""
        return CSR.from_scipy(self.to_scipy().T.tocsr(), capacity=self.capacity)

    @property
    def T(self) -> "CSR":
        return self.transpose()


class CSC:
    """CSC is represented as the CSR of the transpose.

    Kept as a thin namespace: ``CSC.fromdense(a)`` returns ``CSR`` of ``a.T``
    tagged by the caller.  A dedicated class adds nothing because every op
    consumes CSR/ELL layouts.
    """

    @staticmethod
    def fromdense(dense, **kw) -> CSR:
        return CSR.fromdense(np.asarray(dense).T, **kw)
