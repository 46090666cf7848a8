"""SpMV: ``y = A @ x`` for every sparse format.

Each format has one ``jax.numpy`` implementation (the ``_naive`` analogue
of the reference, reference src/sparse/kernel.cc:322-338), compiled
by XLA: vectorized gathers + ``segment_sum`` (CSR/COO), a 2-D
gather/reduce (ELL), or batched block matvecs (BSR/BlockedELL/strips).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import (BSR, COO, CSR, ELL, BlockedELL, CodebookCSR,
                       CodebookDense, Dense, QuantDense, StripDense)
from ..utils.precision import matmul_precision

__all__ = ["spmv", "spmv_reference", "prepare_spmv"]


def _spmv_csr_jnp(A: CSR, x):
    rid = A._row_ids_or_compute()
    prod = A.data * x[A.indices]
    # padding entries have data == 0; out-of-range rid (== rows) are dropped
    return jax.ops.segment_sum(prod, rid, num_segments=A.shape[0])


def _spmv_coo_jnp(A: COO, x):
    prod = A.data * x[A.col]
    return jax.ops.segment_sum(prod, A.row, num_segments=A.shape[0])


def _spmv_ell_jnp(A: ELL, x):
    # (rows, R) gather; padding has data == 0 so no mask needed
    return jnp.sum(A.data * x[A.cols], axis=1)


def _spmv_bsr_jnp(A: BSR, x):
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    nbc = -(-A.shape[1] // bn)
    xp = jnp.zeros((nbc * bn,), x.dtype).at[: A.shape[1]].set(x)
    xb = xp.reshape(nbc, bn)
    gathered = xb[A.indices]  # (block_capacity, bn)
    # block matvec on each stored block: (cap, bm, bn) @ (cap, bn) -> (cap, bm)
    prod = jnp.einsum("kij,kj->ki", A.data, gathered,
                      precision=matmul_precision(A.data.dtype))
    brow = (
        A.block_row_ids
        if A.block_row_ids is not None
        else A._block_row_ids_or_compute()
    )
    acc = jax.ops.segment_sum(prod, brow, num_segments=nbr)  # (nbr, bm)
    return acc.reshape(nbr * bm)[: A.shape[0]]


def _spmv_bell_jnp(A: BlockedELL, x):
    bm, bk = A.block_shape
    nbr, M = A.block_cols.shape
    nbc = -(-A.shape[1] // bk)
    xp = jnp.zeros((nbc * bk,), x.dtype).at[: A.shape[1]].set(x)
    xb = xp.reshape(nbc, bk)
    gathered = xb[A.block_cols]  # (nbr, M, bk) — padded blocks are zero-valued
    acc = jnp.einsum("rmij,rmj->ri", A.blocks, gathered,
                     precision=matmul_precision(A.blocks.dtype))  # (nbr, bm)
    return acc.reshape(nbr * bm)[: A.shape[0]]


def _spmv_codebook_jnp(A: CodebookCSR, x):
    return _spmv_csr_jnp(A.to_csr(), x)


def _spmv_codebook_dense_jnp(A: CodebookDense, x):
    # dtype-aware dequant (same policy as spmm): casting the 256-entry
    # table FIRST halves the materialized-B traffic for bf16 x
    table = (A.val_table if x.dtype == jnp.float32
             else A.val_table.astype(x.dtype))
    return jnp.dot(table[A.idx.astype(jnp.int32)], x,
                   precision=matmul_precision(x.dtype))


def _spmv_dense_jnp(A: Dense, x):
    if A.data.dtype == jnp.bfloat16 and x.dtype == jnp.float32:
        return jnp.dot(A.data, x.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    return jnp.dot(A.data, x, precision=matmul_precision(A.data.dtype))


def _spmv_quantdense_jnp(A: QuantDense, x):
    from .spmm import _spmm_quantdense_jnp

    return _spmm_quantdense_jnp(A, x[:, None])[:, 0]


def _spmv_strip_jnp(A: StripDense, x):
    # per-strip window SLICE + batched matvec.  vmapped dynamic_slice, not
    # an element gather: each index moves one contiguous window.  Windows
    # are in-bounds by construction.
    xg = jax.vmap(
        lambda fc: jax.lax.dynamic_slice(x, (fc,), (A.width,))
    )(A.first_col)  # (n_strips, width)
    y = jnp.einsum("srw,sw->sr", A.strips, xg,
                   precision=matmul_precision(A.strips.dtype))
    return y.reshape(-1)[: A.shape[0]]


_JNP_IMPLS = {
    CSR: _spmv_csr_jnp,
    COO: _spmv_coo_jnp,
    ELL: _spmv_ell_jnp,
    BSR: _spmv_bsr_jnp,
    BlockedELL: _spmv_bell_jnp,
    CodebookCSR: _spmv_codebook_jnp,
    CodebookDense: _spmv_codebook_dense_jnp,
    Dense: _spmv_dense_jnp,
    QuantDense: _spmv_quantdense_jnp,
    StripDense: _spmv_strip_jnp,
}


def spmv_reference(A, x):
    """Pure-jnp SpMV for any format container."""
    impl = _JNP_IMPLS.get(type(A))
    if impl is None:
        raise TypeError(f"spmv: unsupported format {type(A).__name__}")
    return impl(A, x)


def prepare_spmv(A: "CSR", layout: str = "auto", **pack_kwargs):
    """Explicit build step: choose the SpMV layout for a CSR once.

    ``layout``: ``"strip"`` (locally-densified strips for band-local
    matrices — one batched matvec over contiguous x windows) or
    ``"auto"`` (the strip pack when the matrix is band-local and dense
    enough within the band, else the CSR itself).  Host-side, so call it
    outside ``jax.jit`` and pass the result in."""
    if layout == "strip":
        return StripDense.from_csr(A, **pack_kwargs)
    if layout != "auto":
        raise ValueError(f"unknown layout {layout!r}")
    if pack_kwargs:
        raise TypeError(f"layout='auto' takes no pack options, got "
                        f"{sorted(pack_kwargs)}")
    strip = _maybe_strip(A)
    return A if strip is None else strip


def _maybe_strip(A: "CSR"):
    """StripDense pack when the matrix is band-local AND dense within the
    band (strip fill ≥ 0.25, so the dense batched matvec wastes at most
    3× the stored entries); None otherwise.

    Band-locality is judged by ``from_csr`` itself (one scan, one rule —
    a 2048-column window cap here vs its 8192 default)."""
    if A.nnz == 0 or A.shape[0] < 128:
        return None
    try:
        S = StripDense.from_csr(A, max_width=2048)
    except ValueError:
        return None
    if S.fill_rate < 0.25:
        return None
    return S


def spmv(A, x):
    """``y = A @ x`` for any format container (including a
    ``prepare_spmv`` result)."""
    if x.ndim != 1 or x.shape[0] != A.shape[1]:
        raise ValueError(
            f"spmv: x shape {x.shape} incompatible with matrix {A.shape}"
        )
    return spmv_reference(A, x)
