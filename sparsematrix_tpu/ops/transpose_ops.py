"""Transposed products and device-side transpose.

``spmv_t``/``spmm_t``: ``A^T @ x`` without materializing A^T (the same
gather-multiply with ``row_ids``/``indices`` swapped).

``csr_transpose_device``: a full structural transpose computed ON DEVICE
(two stable sorts + searchsorted, all jittable) — the analogue of the
reference's ``sblas_trans_kernel`` (reference src/sparse/
kernel.cc:31-187), besides the host-side transpose via scipy.  Padding entries (zero data, in-range indices) sort to the end and
stay harmless.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import CSR, COO

__all__ = ["spmv_t", "spmm_t", "csr_transpose_device"]


def _ids(A):
    if isinstance(A, CSR):
        return A._row_ids_or_compute(), A.indices
    if isinstance(A, COO):
        return A.row, A.col
    raise TypeError(f"transposed ops support CSR/COO, got {type(A).__name__}")


def spmv_t(A, y):
    """``x = A^T @ y`` for CSR/COO ``A`` (shape m×n), ``y`` length m."""
    if y.shape[0] != A.shape[0]:
        raise ValueError(f"spmv_t: y shape {y.shape} vs matrix {A.shape}")
    rid, cid = _ids(A)
    prod = A.data * jnp.where(rid < A.shape[0], y[jnp.minimum(rid, A.shape[0] - 1)], 0)
    return jax.ops.segment_sum(prod, cid, num_segments=A.shape[1])


def csr_transpose_device(A: CSR) -> CSR:
    """``A^T`` as a new CSR, computed entirely on device (jittable).

    Two stable argsorts (secondary key = source row, then primary key =
    source column, with padding forced last) order the entries into the
    transposed row-major layout; ``searchsorted`` rebuilds ``indptr``.
    Avoids a single fused sort key so no index arithmetic can overflow
    int32 at large shapes.
    """
    m, n = A.shape
    rid = A._row_ids_or_compute()
    valid = rid < m
    eff_cols = jnp.where(valid, A.indices, n)  # pads sort last
    ord1 = jnp.argsort(jnp.where(valid, rid, m), stable=True)
    ord2 = jnp.argsort(eff_cols[ord1], stable=True)
    order = ord1[ord2]
    v_o = valid[order]
    new_rid = jnp.where(v_o, A.indices[order], n)
    new_cols = jnp.where(v_o, jnp.minimum(rid[order], m - 1), 0)
    new_data = jnp.where(v_o, A.data[order], 0)
    indptr = jnp.searchsorted(new_rid, jnp.arange(n + 1), side="left")
    return CSR(
        indptr=indptr.astype(A.indptr.dtype),
        indices=new_cols.astype(A.indices.dtype),
        data=new_data,
        row_ids=new_rid.astype(A.indices.dtype),
        shape=(n, m),
        nnz=A.nnz,
    )


def spmm_t(A, Y):
    """``X = A^T @ Y`` for CSR/COO ``A`` (m×n), ``Y`` (m, k)."""
    if Y.shape[0] != A.shape[0]:
        raise ValueError(f"spmm_t: Y shape {Y.shape} vs matrix {A.shape}")
    rid, cid = _ids(A)
    safe_rid = jnp.minimum(rid, A.shape[0] - 1)
    gathered = jnp.where((rid < A.shape[0])[:, None], Y[safe_rid], 0)
    prod = A.data[:, None] * gathered
    return jax.ops.segment_sum(prod, cid, num_segments=A.shape[1])
