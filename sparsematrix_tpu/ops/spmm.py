"""SpMM: ``Y = A_sparse @ X_dense`` (multi-vector RHS, k = X.shape[1]).

The reference's single math op is the mirror case ``C = A_dense @ B_sparse``
(AddMatMat, reference src/sparse/sparse-matrix.cc:140-194) — provided
here as ``spmm_right`` / ``ops.addmatmat``.  One ``jax.numpy``
implementation per format, compiled by XLA; ``spmm`` routes between them
and the densify path from properties of the input.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import (BSR, COO, CSR, ELL, BlockedELL, CodebookCSR,
                       CodebookDense, Dense, QuantDense, StripDense)
from ..utils.precision import matmul_precision

__all__ = ["spmm", "spmm_reference", "spmm_right"]


def _spmm_csr_jnp(A: CSR, X):
    rid = A._row_ids_or_compute()
    gathered = X[A.indices]  # (cap, k)
    prod = A.data[:, None] * gathered
    return jax.ops.segment_sum(prod, rid, num_segments=A.shape[0])


def _spmm_coo_jnp(A: COO, X):
    prod = A.data[:, None] * X[A.col]
    return jax.ops.segment_sum(prod, A.row, num_segments=A.shape[0])


def _spmm_ell_jnp(A: ELL, X):
    gathered = X[A.cols]  # (rows, R, k)
    return jnp.einsum("rn,rnk->rk", A.data, gathered,
                      precision=matmul_precision(A.data.dtype))


def _spmm_bsr_jnp(A: BSR, X):
    bm, bn = A.block_shape
    nbr = A.num_block_rows
    nbc = -(-A.shape[1] // bn)
    k = X.shape[1]
    Xp = jnp.zeros((nbc * bn, k), X.dtype).at[: A.shape[1]].set(X)
    Xb = Xp.reshape(nbc, bn, k)
    gathered = Xb[A.indices]  # (cap, bn, k)
    prod = jnp.einsum("cij,cjk->cik", A.data, gathered,
                      precision=matmul_precision(A.data.dtype))  # (cap, bm, k)
    brow = (
        A.block_row_ids
        if A.block_row_ids is not None
        else A._block_row_ids_or_compute()
    )
    acc = jax.ops.segment_sum(prod, brow, num_segments=nbr)
    return acc.reshape(nbr * bm, k)[: A.shape[0]]


def _spmm_bell_jnp(A: BlockedELL, X):
    bm, bk = A.block_shape
    nbr, M = A.block_cols.shape
    nbc = -(-A.shape[1] // bk)
    k = X.shape[1]
    Xp = jnp.zeros((nbc * bk, k), X.dtype).at[: A.shape[1]].set(X)
    Xb = Xp.reshape(nbc, bk, k)
    gathered = Xb[A.block_cols]  # (nbr, M, bk, k)
    acc = jnp.einsum("rmij,rmjk->rik", A.blocks, gathered,
                     precision=matmul_precision(A.blocks.dtype))  # (nbr, bm, k)
    return acc.reshape(nbr * bm, k)[: A.shape[0]]


def _spmm_codebook_jnp(A: CodebookCSR, X):
    return _spmm_csr_jnp(A.to_csr(), X)


def _spmm_codebook_dense_jnp(A: CodebookDense, X):
    # dequant (vectorized 256-entry LUT) straight into one dense dot; XLA
    # fuses the table gather into the product's operand.  For non-fp32 RHS
    # the table is cast FIRST so the materialized B plane is half-width.
    table = (A.val_table if X.dtype == jnp.float32
             else A.val_table.astype(X.dtype))
    B = table[A.idx.astype(jnp.int32)]
    return jnp.dot(B, X, preferred_element_type=X.dtype,
                   precision=matmul_precision(X.dtype))


def _spmm_dense_jnp(A: Dense, X):
    if A.data.dtype == jnp.bfloat16 and X.dtype == jnp.float32:
        # half-width A plane on the bf16 tensor-core path;
        # accumulate fp32 so only the input rounding (~1e-2 rel) remains
        return jnp.dot(A.data, X.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    return jnp.dot(A.data, X, preferred_element_type=X.dtype,
                   precision=matmul_precision(A.data.dtype))


def _spmm_quantdense_jnp(A: QuantDense, X):
    # per-column symmetric quantization of X (two elementwise passes), int8
    # contraction with int32 accumulate, rank-1 rescale.  Mirrors the
    # codebook int8-gemm path for arbitrary-valued matrices.
    colmax = jnp.max(jnp.abs(X), axis=0)
    t = jnp.where(colmax > 0, colmax / 127.0, 1.0).astype(jnp.float32)
    Xq = jnp.clip(jnp.round(X / t[None, :]), -127, 127).astype(jnp.int8)
    Yi = jnp.dot(A.data, Xq, preferred_element_type=jnp.int32)
    return (Yi.astype(jnp.float32) * A.scale[:, None] * t[None, :]).astype(
        X.dtype)


def _spmm_strip_jnp(A: StripDense, X):
    # one RHS window SLICE per strip, then a single batched matmul over
    # full 128-row strips.  vmapped dynamic_slice, NOT a fancy gather:
    # X[first_col[:,None]+arange(width)] lowers to an element gather,
    # while the contiguous-slice form moves whole (width, k) blocks per
    # index.  Windows are in-bounds by construction (from_csr clips
    # first_col to cols-width).
    k = X.shape[1]
    Xg = jax.vmap(
        lambda fc: jax.lax.dynamic_slice(X, (fc, 0), (A.width, k))
    )(A.first_col)  # (n_strips, width, k)
    Y = jnp.einsum("srw,swk->srk", A.strips, Xg,
                   precision=matmul_precision(A.strips.dtype))
    return Y.reshape(-1, X.shape[1])[: A.shape[0]]


_JNP_IMPLS = {
    CSR: _spmm_csr_jnp,
    COO: _spmm_coo_jnp,
    ELL: _spmm_ell_jnp,
    BSR: _spmm_bsr_jnp,
    BlockedELL: _spmm_bell_jnp,
    CodebookCSR: _spmm_codebook_jnp,
    CodebookDense: _spmm_codebook_dense_jnp,
    Dense: _spmm_dense_jnp,
    QuantDense: _spmm_quantdense_jnp,
    StripDense: _spmm_strip_jnp,
}


def spmm_reference(A, X):
    impl = _JNP_IMPLS.get(type(A))
    if impl is None:
        raise TypeError(f"spmm: unsupported format {type(A).__name__}")
    return impl(A, X)


def spmm_densify(A, X, precision=None):
    """Density-adaptive path: materialize A on-device (scatter) and run
    one dense matmul.  Above a few percent density the dense product beats
    the reference's stream-of-AXPYs algorithm (kernel.cc:771-800).  fp32
    inputs default to ``matmul_precision`` (true fp32, not TF32).
    """
    if precision is None:
        precision = matmul_precision(X.dtype)
    dense = A.todense()
    return jnp.dot(dense, X, preferred_element_type=X.dtype, precision=precision)


# densify when at least this fraction of entries are stored and the dense
# temporary stays small enough to be a footnote in device memory
_DENSIFY_MIN_DENSITY = 0.05
_DENSIFY_MAX_ELEMS = 64 * 1024 * 1024


def _should_densify(A) -> bool:
    m, n = A.shape
    size = m * n
    return size <= _DENSIFY_MAX_ELEMS and A.nnz >= _DENSIFY_MIN_DENSITY * size


# Build-time conversions of concrete containers, cached per container
# (keyed by identity, evicted by weakref when the container dies) so the
# DEFAULT spmm/add_mat_mat path reaches the dense or strip form with no
# caller-side prep.  Traced containers skip them (inside jit, build the
# converted container ahead of time).
import weakref

_CBD_CACHE: dict = {}
_STRIP_CACHE: dict = {}
_BSR_DENSE_CACHE: dict = {}


def _cached(cache: dict, A, build):
    key = id(A)
    entry = cache.get(key)
    if entry is not None and entry[0]() is A:
        return entry[1]
    # the builders run jnp ops; evaluate eagerly even under an active jit
    # trace (the container itself is concrete)
    with jax.ensure_compile_time_eval():
        out = build(A)
    ref = weakref.ref(A, lambda _u, k=key: cache.pop(k, None))
    cache[key] = (ref, out)
    return out


def _strip_of(A: CSR):
    """Cached StripDense conversion for band-local CSR (the same rule as
    ``prepare_spmv``'s auto layout).  Misses are cached too: the band scan
    is one O(nnz) pass, but spmm may be called per step."""
    import jax.core

    if isinstance(A.data, jax.core.Tracer):
        return None
    from .spmv import _maybe_strip

    return _cached(_STRIP_CACHE, A, _maybe_strip)


def _bsr_dense_of(A: BSR):
    """Cached Dense materialization of a small-block BSR.  A TRACED
    todense() would re-scatter on every call; caching the concrete
    container makes the auto path one dense contraction."""
    import jax.core

    if isinstance(A.data, jax.core.Tracer):
        return None
    return _cached(_BSR_DENSE_CACHE, A, Dense.from_sparse)


def _codebook_dense_of(A: CodebookCSR):
    import jax.core

    if isinstance(A.indptr, jax.core.Tracer):
        return None  # inside jit: build a CodebookDense ahead of time
    if A.shape[0] * A.shape[1] > _DENSIFY_MAX_ELEMS:
        return None  # index plane too large to materialize

    def build(A):
        import numpy as np

        rid = np.asarray(A.row_ids)[: A.nnz]
        cid = np.asarray(A.indices)[: A.nnz]
        vi = np.asarray(A.val_idx)[: A.nnz]
        idxm = np.full(A.shape, A.table_size, np.int64)  # sentinel = zero
        idxm[rid, cid] = vi
        return CodebookDense.from_index_matrix(
            idxm, np.asarray(A.val_table)[: A.table_size])

    return _cached(_CBD_CACHE, A, build)


def spmm(A, X, method: str = "auto"):
    """``Y = A @ X`` with sparse ``A`` and dense ``X``.

    method: "auto" (density-adaptive), "sparse" (the format's own
    implementation), or "densify" (force the dense matmul path).
    """
    if X.ndim != 2 or X.shape[0] != A.shape[1]:
        raise ValueError(
            f"spmm: X shape {X.shape} incompatible with matrix {A.shape}"
        )
    if method not in ("auto", "sparse", "densify"):
        raise ValueError(f"unknown method {method!r}")
    from .spmm_lowdeg import SlicedEllMM, spmm_sliced_ell

    if isinstance(A, SlicedEllMM):
        return spmm_sliced_ell(A, X)
    if method == "densify":
        return spmm_densify(A, X)
    if type(A) in (Dense, QuantDense) or method != "auto":
        # already-materialized containers: their jnp impl IS the fast path
        # (bf16 plane / int8 contraction) — never re-densify
        return spmm_reference(A, X)
    if type(A) is BSR and _should_densify(A):
        # small blocks make tiny batched products; at densify-eligible
        # density one dense contraction does the work in a single call.
        # Large blocks ((64,64)+) keep the batched block product.
        bm, bn = A.block_shape
        if bm * bn < 4096:
            bd = _bsr_dense_of(A)
            if bd is not None:  # build-time materialization, cached
                return spmm_reference(bd, X)
            return spmm_densify(A, X)
    if type(A) is CodebookCSR:
        bd = _codebook_dense_of(A)
        if bd is not None:
            return _spmm_codebook_dense_jnp(bd, X)  # dequant + dense dot
    if type(A) is CSR and not _should_densify(A):
        S = _strip_of(A)
        if S is not None:  # band-local: one batched strip product
            return _spmm_strip_jnp(S, X)
    if _should_densify(A):
        return spmm_densify(A, X)
    return spmm_reference(A, X)


def spmm_right(X, A_transposed):
    """``Y = X_dense @ A_sparse`` via the transpose identity
    ``X @ A = (A^T @ X^T)^T``.

    ``A_transposed`` must be the sparse storage of ``A^T`` (shape n×k for a
    logical k×n ``A``), prepared at *build* time — exactly as the reference
    encodes B with ``SblasTrans`` at encode time so the multiply never
    transposes sparse data (reference src/test/blas_test.h:145,
    sparse-matrix.cc:65-98).  Jit-safe: no host-side work here.
    """
    return spmm(A_transposed, X.T).T
