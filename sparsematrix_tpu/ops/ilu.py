"""ILU(0) — incomplete LU factorization with zero fill-in.

Host-side factorization (classic IKJ on CSR structure; setup-time work,
like the reference's encode phase) producing unit-lower L and upper U on
A's own sparsity pattern; device-side preconditioner application
``M⁻¹ r = U⁻¹ (L⁻¹ r)`` via the level-scheduled triangular solver.

No reference analogue (SURVEY §7 phase C); verified against
scipy.sparse.linalg.splu on dense-comparable problems and by
preconditioned-residual reduction.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR
from .trisolve import (
    TriFixPlan,
    TriSolvePlan,
    trisolve_apply,
    trisolve_fixpoint_apply,
    trisolve_fixpoint_plan,
    trisolve_plan,
)

__all__ = ["ilu0", "ilu0_plans", "ilu0_fixpoint_plans", "ilu_apply"]


def _ilu0_factor_python(indptr, indices, a, n):
    """Behavioral reference for the native factorization (same IKJ walk)."""
    col_pos = [
        {int(indices[s]): s for s in range(indptr[i], indptr[i + 1])}
        for i in range(n)
    ]
    for i in range(n):
        if i not in col_pos[i]:
            raise ValueError(f"ilu0: missing diagonal at row {i}")
    for i in range(1, n):
        for s in range(indptr[i], indptr[i + 1]):
            k = int(indices[s])
            if k >= i:
                break
            piv = a[col_pos[k][k]]
            if piv == 0:
                raise ZeroDivisionError(f"ilu0: zero pivot at {k}")
            lik = a[s] / piv
            a[s] = lik
            for t in range(indptr[k], indptr[k + 1]):
                j = int(indices[t])
                if j <= k:
                    continue
                pos = col_pos[i].get(j)
                if pos is not None:
                    a[pos] -= lik * a[t]


def _ilu0_factor_native(indptr, indices, a, n) -> bool:
    """Native C++ IKJ (native/codec.cc: smtpu_ilu0); returns False when the
    library is unavailable."""
    from .. import native as native_mod

    lib = native_mod.get_lib()
    if lib is None or not hasattr(lib, "smtpu_ilu0"):
        return False
    import ctypes

    ip = np.ascontiguousarray(indptr, np.int64)
    ix = np.ascontiguousarray(indices, np.int32)
    rc = lib.smtpu_ilu0(
        ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
    )
    if rc == 0:
        return True
    if rc >= -n:
        raise ValueError(f"ilu0: missing diagonal at row {-1 - rc}")
    raise ZeroDivisionError(f"ilu0: zero pivot at {-rc - n - 1}")


def ilu0(A: CSR) -> Tuple[CSR, CSR]:
    """Factor A ≈ L @ U on A's sparsity pattern.  L unit-lower, U upper.

    Host build-time setup (the reference's encode-once stance); the
    factorization loop runs in native C++ when available, with the Python
    IKJ walk as the behavioral fallback.
    """
    sp = A.to_scipy().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("ilu0 needs a square matrix")
    indptr, indices = sp.indptr, sp.indices
    a = np.ascontiguousarray(sp.data, np.float64).copy()

    if not _ilu0_factor_native(indptr, indices, a, n):
        _ilu0_factor_python(indptr, indices, a, n)

    # split into L (unit diag appended) and U — vectorized masks
    import scipy.sparse as ss

    rid = np.repeat(np.arange(n), np.diff(indptr))
    cols = indices.astype(np.int64)
    low = cols < rid
    dt = sp.data.dtype
    lr = np.concatenate([rid[low], np.arange(n)])
    lc = np.concatenate([cols[low], np.arange(n)])
    lv = np.concatenate([a[low], np.ones(n)]).astype(dt)
    L = CSR.from_scipy(ss.coo_matrix((lv, (lr, lc)), shape=(n, n)).tocsr())
    U = CSR.from_scipy(
        ss.coo_matrix((a[~low].astype(dt), (rid[~low], cols[~low])),
                      shape=(n, n)).tocsr()
    )
    return L, U


def ilu0_plans(A: CSR) -> Tuple[TriSolvePlan, TriSolvePlan]:
    """Factor + build device solve plans (setup once, apply many)."""
    L, U = ilu0(A)
    return (
        trisolve_plan(L, lower=True, unit_diagonal=True),
        trisolve_plan(U, lower=False, unit_diagonal=False),
    )


def ilu0_fixpoint_plans(A: CSR, n_iters: int | None = None,
                        capacity: int | None = None
                        ) -> Tuple[TriFixPlan, TriFixPlan]:
    """Factor + build fixed-point (SpMV-formulated) solve plans.

    The triangular solves run as nilpotent Jacobi iterations, one CSR
    SpMV each.  ``n_iters`` truncates both solves (approximate
    preconditioner, still a fixed linear operator); ``None`` → exact.
    """
    L, U = ilu0(A)
    return (
        trisolve_fixpoint_plan(L, lower=True, unit_diagonal=True,
                               n_iters=n_iters, capacity=capacity),
        trisolve_fixpoint_plan(U, lower=False, unit_diagonal=False,
                               n_iters=n_iters, capacity=capacity),
    )


def ilu_apply(plans, r):
    """Apply the preconditioner: ``M⁻¹ r`` (jittable).

    Accepts level-scheduled or fixed-point plan pairs.  A 2-D ``r``
    panel (n, k) solves its columns through one vmapped solve."""
    lp, up = plans
    apply_ = (trisolve_fixpoint_apply if isinstance(lp, TriFixPlan)
              else trisolve_apply)
    solve = lambda c: apply_(up, apply_(lp, c))
    if jnp.ndim(r) == 2:
        return jax.vmap(solve, in_axes=1, out_axes=1)(r)
    return solve(r)
