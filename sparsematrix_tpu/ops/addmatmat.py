"""``add_mat_mat`` — the reference's single math op, with identical semantics.

``C = beta * C + alpha * A_dense(m×k) @ B_sparse(k×n)``
(reference src/sparse/sparse-matrix.cc:140-194: beta pre-pass at
:149-151, alpha folded into gathered values at kernel.cc:239).

Formulation: B is stored **pre-transposed** (``B_t``: n×k sparse, built
with ``trans=True`` — the reference's ``SblasTrans`` encode,
blas_test.h:145), so the product is a plain SpMM:
``A @ B = (B^T @ A^T)^T = spmm(B_t, A^T)^T``.
No runtime transposition of sparse data ever happens, and XLA fuses the two
dense transposes into layout choices (the reference instead spends real time
in ``sblas_trans_kernel`` scratch transposes, sparse-matrix.cc:180-189 —
overhead this design eliminates by construction).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .spmm import spmm

__all__ = ["add_mat_mat"]


def add_mat_mat(a, b_t_sparse, c=None, alpha=1.0, beta=0.0):
    """Compute ``beta*C + alpha * A @ B`` with ``B`` given as sparse ``B^T``.

    Args:
      a: dense (m, k).
      b_t_sparse: sparse container storing ``B^T`` with shape (n, k).
      c: optional dense (m, n); required when ``beta != 0``.
      alpha, beta: scalars (reference defaults: alpha=beta=1.0 for the sparse
        benchmark path, blas_test.h:313).
    Returns:
      dense (m, n).
    """
    if c is None:
        try:
            beta_static = float(beta)
        except (TypeError, jax.errors.TracerArrayConversionError,
                jax.errors.ConcretizationTypeError):
            beta_static = None  # traced beta: cannot prove it is 0
        if beta_static is None or beta_static != 0.0:
            raise ValueError("add_mat_mat: beta != 0 requires c (the matrix "
                             "being accumulated into)")
    prod = spmm(b_t_sparse, a.T).T  # (m, n)
    out = alpha * prod
    if c is not None:
        out = out + beta * jnp.asarray(c)
    return out
