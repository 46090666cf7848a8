"""ELL and Blocked-ELL formats — padded compute layouts.

``ELL``: every row padded to a fixed entry count ``R`` → dense (rows, R)
index/value planes, fully vectorizable.  Optionally row-sorted
within windows (SELL-C-sigma style) via ``convert.csr_to_ell`` to reduce
padding waste.

``BlockedELL``: the matrix is tiled into (bm × bk) dense blocks; each
block-row stores a fixed number of nonzero blocks.  SpMM then becomes a sum
of dense (bm × bk) @ (bk × n) matmuls indexed by ``block_cols`` — a
batched dense product.  This replaces the reference's per-nonzero AXPY
hot loop (reference src/sparse/kernel.cc:771-800) with block
matmuls.

Padding entries reference column 0 with zero values, generalizing the
reference's sentinel-zero filler (sparse-matrix.cc:29-31): padding
contributes exactly 0 to every accumulation.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, default_index_dtype, register_sparse_pytree

__all__ = ["ELL", "BlockedELL"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class ELL(SparseFormat):
    cols: jnp.ndarray  # (rows, R) int32
    data: jnp.ndarray  # (rows, R)
    valid: jnp.ndarray  # (rows, R) bool — True for stored entries
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def row_capacity(self) -> int:
        return self.cols.shape[1]

    @classmethod
    def fromdense(cls, dense, row_capacity: int | None = None,
                  index_dtype=default_index_dtype, truncate: bool = False):
        """Rows with more than ``row_capacity`` entries raise unless
        ``truncate=True``; when truncating, ``nnz`` reflects the entries
        actually stored (so fill-rate / nnz/s metrics stay honest)."""
        dense = np.asarray(dense)
        rows, _ = dense.shape
        counts = (dense != 0).sum(axis=1)
        R = int(counts.max()) if row_capacity is None else int(row_capacity)
        R = max(R, 1)
        if counts.size and int(counts.max()) > R and not truncate:
            raise ValueError(
                f"ELL.fromdense: a row has {int(counts.max())} entries > "
                f"row_capacity={R}; pass truncate=True to drop the excess"
            )
        cols = np.zeros((rows, R), dtype=np.int64)
        vals = np.zeros((rows, R), dtype=dense.dtype)
        valid = np.zeros((rows, R), dtype=bool)
        for i in range(rows):
            (cidx,) = np.nonzero(dense[i])
            cidx = cidx[:R]
            cols[i, : len(cidx)] = cidx
            vals[i, : len(cidx)] = dense[i, cidx]
            valid[i, : len(cidx)] = True
        return cls(
            cols=jnp.asarray(cols, dtype=index_dtype),
            data=jnp.asarray(vals),
            valid=jnp.asarray(valid),
            shape=(int(rows), int(dense.shape[1])),
            nnz=int(np.minimum(counts, R).sum()),
        )

    def todense(self):
        rows, R = self.cols.shape
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        rid = jnp.broadcast_to(
            jnp.arange(rows, dtype=self.cols.dtype)[:, None], (rows, R)
        )
        # zero padding values make duplicate (row,0) scatters harmless
        return out.at[rid.ravel(), self.cols.ravel()].add(self.data.ravel())


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class BlockedELL(SparseFormat):
    block_cols: jnp.ndarray  # (nbr, max_blocks) int32 — block-column ids
    blocks: jnp.ndarray  # (nbr, max_blocks, bm, bk) values
    valid: jnp.ndarray  # (nbr, max_blocks) bool
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})  # scalar nnz pre-blocking
    block_shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})

    @property
    def num_block_rows(self) -> int:
        return self.block_cols.shape[0]

    @property
    def max_blocks_per_row(self) -> int:
        return self.block_cols.shape[1]

    @classmethod
    def fromdense(cls, dense, block_shape: Tuple[int, int] = (8, 128),
                  max_blocks_per_row: int | None = None,
                  index_dtype=default_index_dtype, truncate: bool = False):
        dense = np.asarray(dense)
        rows, cols = dense.shape
        bm, bk = block_shape
        nbr = -(-rows // bm)
        nbc = -(-cols // bk)
        padded = np.zeros((nbr * bm, nbc * bk), dtype=dense.dtype)
        padded[:rows, :cols] = dense
        # (nbr, nbc, bm, bk) view
        tiles = padded.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
        nonempty = np.abs(tiles).sum(axis=(2, 3)) != 0  # (nbr, nbc)
        per_row = nonempty.sum(axis=1)
        M = int(per_row.max()) if per_row.size else 0
        if max_blocks_per_row is not None:
            M = int(max_blocks_per_row)
        M = max(M, 1)
        if per_row.size and int(per_row.max()) > M and not truncate:
            raise ValueError(
                f"BlockedELL.fromdense: a block-row has {int(per_row.max())} "
                f"blocks > max_blocks_per_row={M}; pass truncate=True to "
                "drop the excess"
            )
        block_cols = np.zeros((nbr, M), dtype=np.int64)
        blocks = np.zeros((nbr, M, bm, bk), dtype=dense.dtype)
        valid = np.zeros((nbr, M), dtype=bool)
        stored_nnz = 0
        for i in range(nbr):
            (bcids,) = np.nonzero(nonempty[i])
            bcids = bcids[:M]
            block_cols[i, : len(bcids)] = bcids
            blocks[i, : len(bcids)] = tiles[i, bcids]
            valid[i, : len(bcids)] = True
            stored_nnz += int((tiles[i, bcids] != 0).sum())
        return cls(
            block_cols=jnp.asarray(block_cols, dtype=index_dtype),
            blocks=jnp.asarray(blocks),
            valid=jnp.asarray(valid),
            shape=(int(rows), int(cols)),
            nnz=stored_nnz,
            block_shape=(int(bm), int(bk)),
        )

    def todense(self):
        nbr, M = self.block_cols.shape
        bm, bk = self.block_shape
        nbc = -(-self.shape[1] // bk)
        out = jnp.zeros((nbr, nbc, bm, bk), dtype=self.blocks.dtype)
        brow = jnp.broadcast_to(
            jnp.arange(nbr, dtype=self.block_cols.dtype)[:, None], (nbr, M)
        )
        # mask padded blocks to zero before scattering (a padded slot may
        # collide with a real block at block-col 0)
        contrib = jnp.where(self.valid[:, :, None, None], self.blocks, 0)
        out = out.at[brow.ravel(), self.block_cols.ravel()].add(
            contrib.reshape(-1, bm, bk)
        )
        dense = out.transpose(0, 2, 1, 3).reshape(nbr * bm, nbc * bk)
        return dense[: self.shape[0], : self.shape[1]]

    @property
    def stored_density(self) -> float:
        """Fraction of stored block slots that are real (non-padding)."""
        return float(np.asarray(self.valid).sum()) / self.valid.size
