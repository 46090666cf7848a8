"""IC(0) — incomplete Cholesky factorization with zero fill-in.

For SPD systems the symmetric analogue of ILU(0): factor ``A ≈ L @ L^T``
on the sparsity pattern of ``tril(A)``, then precondition with
``M⁻¹ r = L⁻ᵀ (L⁻¹ r)``.  Host-side build (the reference's encode-once
stance, reference src/sparse/sparse-matrix.cc:21 — setup is a
host-time phase); the device-side solves reuse both triangular-solve
engines (level-scheduled scan, fixed-point), with the upper solve
running on ``L^T``.

No reference analogue (SURVEY §7 phase C); verified by the pattern
identity ``(L L^T)[i,j] == A[i,j]`` on stored positions of ``tril(A)``
and by preconditioned-CG residual reduction.
"""
from __future__ import annotations

import numpy as np

from ..formats import CSR
from .trisolve import trisolve_fixpoint_plan, trisolve_plan

__all__ = ["ic0", "ic0_plans", "ic0_fixpoint_plans", "ic_apply"]


def _ic0_factor_python(indptr, indices, a, n):
    """Behavioral reference for the native factorization (same walk)."""
    for i in range(n):
        end = indptr[i + 1]
        if end == indptr[i] or indices[end - 1] != i:
            raise ValueError(f"ic0: missing diagonal at row {i}")
        for s in range(indptr[i], end):
            j = int(indices[s])
            acc = 0.0
            p, t = indptr[i], indptr[j]
            tend = indptr[j + 1] - 1
            while p < s and t < tend:
                if indices[p] < indices[t]:
                    p += 1
                elif indices[p] > indices[t]:
                    t += 1
                else:
                    acc += a[p] * a[t]
                    p += 1
                    t += 1
            if j < i:
                piv = a[tend]
                if piv <= 0.0:
                    raise ZeroDivisionError(
                        f"ic0: non-positive pivot at row {j}")
                a[s] = (a[s] - acc) / piv
            else:
                d = a[s] - acc
                if d <= 0.0:
                    raise ZeroDivisionError(
                        f"ic0: non-positive pivot at row {i}")
                a[s] = np.sqrt(d)


def _ic0_factor_native(indptr, indices, a, n) -> bool:
    """Native C++ walk (native/codec.cc: smtpu_ic0); False if unavailable."""
    from .. import native as native_mod

    lib = native_mod.get_lib()
    if lib is None or not hasattr(lib, "smtpu_ic0"):
        return False
    import ctypes

    ip = np.ascontiguousarray(indptr, np.int64)
    ix = np.ascontiguousarray(indices, np.int32)
    rc = lib.smtpu_ic0(
        ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
    )
    if rc == 0:
        return True
    if rc >= -n:
        raise ValueError(f"ic0: missing diagonal at row {-1 - rc}")
    raise ZeroDivisionError(f"ic0: non-positive pivot at row {-rc - n - 1}")


def ic0(A: CSR) -> CSR:
    """Factor SPD ``A ≈ L @ L^T`` on ``tril(A)``'s pattern; returns L.

    Only the lower triangle of ``A`` is read (the upper triangle is
    assumed symmetric, as scipy's convention for SPD solvers).
    """
    import scipy.sparse as ss

    sp = A.to_scipy().tocsr()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("ic0 needs a square matrix")
    low = ss.tril(sp, k=0).tocsr()
    low.sort_indices()
    indptr = low.indptr.astype(np.int64)
    indices = low.indices
    a = np.ascontiguousarray(low.data, np.float64).copy()
    if not _ic0_factor_native(indptr, indices, a, n):
        _ic0_factor_python(indptr, indices, a, n)
    L = ss.csr_matrix((a.astype(sp.data.dtype), indices, low.indptr),
                      shape=(n, n))
    return CSR.from_scipy(L)


def _lt(L: CSR) -> CSR:
    """Host-side ``L^T`` (upper triangular) for the second solve."""
    return CSR.from_scipy(L.to_scipy().T.tocsr())


def ic0_plans(A: CSR):
    """Factor + level-scheduled solve plans: ``(L lower, L^T upper)``."""
    L = ic0(A)
    return (
        trisolve_plan(L, lower=True, unit_diagonal=False),
        trisolve_plan(_lt(L), lower=False, unit_diagonal=False),
    )


def ic0_fixpoint_plans(A: CSR, n_iters: int | None = None,
                       capacity: int | None = None):
    """Factor + fixed-point (SpMV-formulated) solve plans; ``n_iters``
    truncates both solves (approximate preconditioner)."""
    L = ic0(A)
    return (
        trisolve_fixpoint_plan(L, lower=True, unit_diagonal=False,
                               n_iters=n_iters, capacity=capacity),
        trisolve_fixpoint_plan(_lt(L), lower=False, unit_diagonal=False,
                               n_iters=n_iters, capacity=capacity),
    )


def ic_apply(plans, r):
    """Apply the preconditioner ``M⁻¹ r = L⁻ᵀ (L⁻¹ r)`` (jittable).

    Same plan-family dispatch as ``ilu_apply`` — any (lower, upper) pair.
    """
    from .ilu import ilu_apply

    return ilu_apply(plans, r)
