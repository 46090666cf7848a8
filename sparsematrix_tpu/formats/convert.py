"""Format conversions.

All conversions are host-side build-time operations (the reference's
encode-once / multiply-many design, ``CopyForm``
reference src/sparse/sparse-matrix.cc:21-99).  They go through scipy
or numpy and return statically-shaped device containers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .bsr import BSR
from .coo import COO
from .csr import CSR
from .ell import ELL, BlockedELL

__all__ = [
    "coo_to_csr",
    "csr_to_coo",
    "csr_to_ell",
    "csr_to_blocked_ell",
    "csr_to_bsr",
    "bsr_to_csr",
    "ell_to_csr",
]


def coo_to_csr(coo: COO, capacity: int | None = None) -> CSR:
    return CSR.from_scipy(coo.to_scipy(), capacity=capacity or coo.capacity)


def csr_to_coo(csr: CSR, capacity: int | None = None) -> COO:
    return COO.from_scipy(csr.to_scipy(), capacity=capacity or csr.capacity)


def csr_to_ell(csr: CSR, row_capacity: int | None = None,
               sort_rows: bool = False,
               truncate: bool = False) -> Tuple[ELL, np.ndarray]:
    """CSR → ELL.  With ``sort_rows=True`` rows are permuted by descending nnz
    (SELL-C-sigma-style, sigma = all rows) to reduce padding waste; returns
    the row permutation (identity when not sorting) so callers can un-permute
    results: ``y[perm] = y_ell``.  Rows exceeding ``row_capacity`` raise
    unless ``truncate=True``; a truncated ELL's ``nnz`` counts only stored
    entries.
    """
    sp = csr.to_scipy()
    rows = sp.shape[0]
    counts = np.diff(sp.indptr)
    perm = np.argsort(-counts, kind="stable") if sort_rows else np.arange(rows)
    R = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if row_capacity is not None:
        R = int(row_capacity)
        if counts.size and int(counts.max()) > R and not truncate:
            raise ValueError(
                f"csr_to_ell: a row has {int(counts.max())} entries > "
                f"row_capacity={R}; pass truncate=True to drop the excess"
            )
    import jax.numpy as jnp

    cols = np.zeros((rows, R), dtype=np.int64)
    vals = np.zeros((rows, R), dtype=sp.data.dtype)
    valid = np.zeros((rows, R), dtype=bool)
    stored = 0
    for out_i, i in enumerate(perm):
        s, e = sp.indptr[i], sp.indptr[i + 1]
        k = min(e - s, R)
        cols[out_i, :k] = sp.indices[s : s + k]
        vals[out_i, :k] = sp.data[s : s + k]
        valid[out_i, :k] = True
        stored += k
    ell = ELL(
        cols=jnp.asarray(cols, dtype=csr.indices.dtype),
        data=jnp.asarray(vals),
        valid=jnp.asarray(valid),
        shape=csr.shape,
        nnz=stored,
    )
    return ell, perm


def csr_to_blocked_ell(csr: CSR, block_shape=(8, 128),
                       max_blocks_per_row: int | None = None,
                       truncate: bool = False) -> BlockedELL:
    """CSR → BlockedELL without densifying the whole matrix: block occupancy
    is computed on the scipy structure, then only non-empty blocks are
    materialized.  Block-rows exceeding ``max_blocks_per_row`` raise unless
    ``truncate=True``."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    bm, bk = block_shape
    nbr = -(-rows // bm)
    nbc = -(-cols // bk)
    bsr = sp.tobsr(blocksize=(bm, bk)) if rows % bm == 0 and cols % bk == 0 else None
    if bsr is None:
        import scipy.sparse as s

        indptr = np.concatenate(
            [sp.indptr, np.full(nbr * bm - rows, sp.indptr[-1], sp.indptr.dtype)]
        )
        padded = s.csr_matrix((sp.data, sp.indices, indptr), shape=(nbr * bm, nbc * bk))
        bsr = padded.tobsr(blocksize=(bm, bk))
    bsr.sort_indices()
    counts = np.diff(bsr.indptr)
    M = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if max_blocks_per_row is not None:
        M = int(max_blocks_per_row)
        if counts.size and int(counts.max()) > M and not truncate:
            raise ValueError(
                f"csr_to_blocked_ell: a block-row has {int(counts.max())} "
                f"blocks > max_blocks_per_row={M}; pass truncate=True to "
                "drop the excess"
            )
    import jax.numpy as jnp

    block_cols = np.zeros((nbr, M), dtype=np.int64)
    blocks = np.zeros((nbr, M, bm, bk), dtype=sp.data.dtype)
    valid = np.zeros((nbr, M), dtype=bool)
    stored_nnz = 0
    for i in range(nbr):
        s_, e_ = bsr.indptr[i], bsr.indptr[i + 1]
        k = min(e_ - s_, M)
        block_cols[i, :k] = bsr.indices[s_ : s_ + k]
        blocks[i, :k] = bsr.data[s_ : s_ + k]
        valid[i, :k] = True
        stored_nnz += int((bsr.data[s_ : s_ + k] != 0).sum())
    return BlockedELL(
        block_cols=jnp.asarray(block_cols, dtype=csr.indices.dtype),
        blocks=jnp.asarray(blocks),
        valid=jnp.asarray(valid),
        shape=(rows, cols),
        nnz=stored_nnz,
        block_shape=(bm, bk),
    )


def csr_to_bsr(csr: CSR, block_shape=(8, 8), block_capacity: int | None = None) -> BSR:
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    bm, bn = block_shape
    nbr = -(-rows // bm)
    nbc = -(-cols // bn)
    import scipy.sparse as s
    import jax.numpy as jnp

    indptr = np.concatenate(
        [sp.indptr, np.full(nbr * bm - rows, sp.indptr[-1], sp.indptr.dtype)]
    )
    padded = s.csr_matrix((sp.data, sp.indices, indptr), shape=(nbr * bm, nbc * bn))
    b = padded.tobsr(blocksize=(bm, bn))
    b.sort_indices()
    nblocks = int(b.indices.shape[0])
    cap = max(nblocks, 1) if block_capacity is None else int(block_capacity)
    indices = np.zeros((cap,), dtype=np.int64)
    indices[:nblocks] = b.indices
    blocks = np.zeros((cap, bm, bn), dtype=sp.data.dtype)
    blocks[:nblocks] = b.data
    brow = np.full((cap,), nbr, dtype=np.int64)
    brow[:nblocks] = np.repeat(np.arange(nbr), np.diff(b.indptr))
    from .base import default_index_dtype

    return BSR(
        indptr=jnp.asarray(b.indptr, dtype=default_index_dtype),
        indices=jnp.asarray(indices, dtype=default_index_dtype),
        data=jnp.asarray(blocks),
        block_row_ids=jnp.asarray(brow, dtype=default_index_dtype),
        shape=(rows, cols),
        nnz=csr.nnz,
        block_shape=(bm, bn),
        num_blocks=nblocks,
    )


def bsr_to_csr(bsr: BSR, capacity: int | None = None) -> CSR:
    return CSR.fromdense(np.asarray(bsr.todense()), capacity=capacity)


def ell_to_csr(ell: ELL, capacity: int | None = None) -> CSR:
    return CSR.fromdense(np.asarray(ell.todense()), capacity=capacity)
