"""BSR (block compressed sparse row) format.

Block-CSR with dense (bm × bn) blocks; SpMV/SpMM over BSR are dense
block-matmuls indexed by block-CSR structure.  Padding block slots point at
block-column 0 with zero values (harmless-accumulation padding, generalizing
the reference sentinel trick, reference src/sparse/sparse-matrix.cc:29-31).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, default_index_dtype, register_sparse_pytree

__all__ = ["BSR"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class BSR(SparseFormat):
    indptr: jnp.ndarray  # (nbr+1,) int32
    indices: jnp.ndarray  # (block_capacity,) int32 block-column ids
    data: jnp.ndarray  # (block_capacity, bm, bn)
    block_row_ids: Optional[jnp.ndarray]  # (block_capacity,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})  # scalar nnz
    block_shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    num_blocks: int = dataclasses.field(metadata={"static": True})

    @property
    def block_capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def num_block_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @classmethod
    def fromdense(cls, dense, block_shape: Tuple[int, int] = (8, 8),
                  block_capacity: int | None = None,
                  index_dtype=default_index_dtype):
        dense = np.asarray(dense)
        rows, cols = dense.shape
        bm, bn = block_shape
        nbr = -(-rows // bm)
        nbc = -(-cols // bn)
        padded = np.zeros((nbr * bm, nbc * bn), dtype=dense.dtype)
        padded[:rows, :cols] = dense
        tiles = padded.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
        nonempty = np.abs(tiles).sum(axis=(2, 3)) != 0  # (nbr, nbc)
        counts = nonempty.sum(axis=1)
        indptr = np.zeros(nbr + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(counts)
        nblocks = int(indptr[-1])
        cap = max(nblocks, 1) if block_capacity is None else int(block_capacity)
        indices = np.zeros((cap,), dtype=np.int64)
        blocks = np.zeros((cap, bm, bn), dtype=dense.dtype)
        brow = np.full((cap,), nbr, dtype=np.int64)
        k = 0
        for i in range(nbr):
            (bcids,) = np.nonzero(nonempty[i])
            for j in bcids:
                indices[k] = j
                blocks[k] = tiles[i, j]
                brow[k] = i
                k += 1
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=jnp.asarray(indices, dtype=index_dtype),
            data=jnp.asarray(blocks),
            block_row_ids=jnp.asarray(brow, dtype=index_dtype),
            shape=(int(rows), int(cols)),
            nnz=int((dense != 0).sum()),
            block_shape=(int(bm), int(bn)),
            num_blocks=nblocks,
        )

    @classmethod
    def from_scipy(cls, mat, block_shape=(8, 8), **kw):
        return cls.fromdense(np.asarray(mat.todense()), block_shape=block_shape, **kw)

    def todense(self):
        bm, bn = self.block_shape
        nbr = self.num_block_rows
        nbc = -(-self.shape[1] // bn)
        out = jnp.zeros((nbr + 1, nbc, bm, bn), dtype=self.data.dtype)
        brow = (
            self.block_row_ids
            if self.block_row_ids is not None
            else self._block_row_ids_or_compute()
        )
        out = out.at[brow, self.indices].add(self.data)
        dense = out[:nbr].transpose(0, 2, 1, 3).reshape(nbr * bm, nbc * bn)
        return dense[: self.shape[0], : self.shape[1]]

    def _block_row_ids_or_compute(self):
        pos = jnp.arange(self.block_capacity, dtype=self.indptr.dtype)
        return (
            jnp.searchsorted(self.indptr, pos, side="right").astype(self.indptr.dtype)
            - 1
        )

    def to_scipy(self):
        import scipy.sparse as sp

        bm, bn = self.block_shape
        return sp.bsr_matrix(
            (
                np.asarray(self.data)[: self.num_blocks],
                np.asarray(self.indices)[: self.num_blocks],
                np.asarray(self.indptr),
            ),
            shape=(self.num_block_rows * bm, (-(-self.shape[1] // bn)) * bn),
        )[: self.shape[0], : self.shape[1]]
