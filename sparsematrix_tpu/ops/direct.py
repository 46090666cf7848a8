"""Sparse direct solve: host SuperLU factorization, device-resident solves.

Factorization is a one-time host step (scipy ``splu`` — supernodal LU
with fill-reducing column permutation); the triangular factors are then
planned for the level-scheduled solve (ops/trisolve.py), so REPEATED
solves against new right-hand sides run entirely on device: two gathers
(the row/column permutations) around two level-scan triangular solves.

scipy's convention is ``A = Pr^T @ L @ U @ Pc^T`` (perm_r/perm_c as
index arrays), hence ``x = Pc @ U⁻¹ L⁻¹ (Pr @ b)``; both permutations
become device gathers with host-precomputed index vectors.

The reference has no solver layer (SURVEY §1); this rounds out the
north-star solve surface (iterative CG/BiCGSTAB/GMRES/LSQR +
incomplete-factor preconditioners) with an exact direct method.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..formats.base import register_sparse_pytree
from ..formats.csr import CSR
from .ilu import ilu_apply
from .trisolve import TriSolvePlan, trisolve_plan

__all__ = ["splu_plans", "splu_solve", "SpluSolver"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class SpluSolver:
    l_plan: TriSolvePlan  # unit-lower
    u_plan: TriSolvePlan  # upper
    inv_perm_r: jnp.ndarray  # (n,) int32 — gather indices for Pr @ b
    perm_c: jnp.ndarray  # (n,) int32 — gather indices for Pc @ y
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    lu_nnz: int = dataclasses.field(metadata={"static": True})  # fill incl.


def splu_plans(A: CSR) -> SpluSolver:
    """Factor ``A`` (square, nonsingular) with SuperLU and build the
    device solve plans."""
    import scipy.sparse.linalg as spla

    if A.shape[0] != A.shape[1]:
        raise ValueError(f"splu needs a square matrix, got {A.shape}")
    lu = spla.splu(A.to_scipy().tocsc())
    n = A.shape[0]
    L = CSR.from_scipy(lu.L.tocsr())
    U = CSR.from_scipy(lu.U.tocsr())
    # (Pr @ b)[perm_r[i]] = b[i]  ⇔  gather with the inverse permutation
    inv_pr = np.empty(n, np.int32)
    inv_pr[lu.perm_r] = np.arange(n, dtype=np.int32)
    return SpluSolver(
        l_plan=trisolve_plan(L, lower=True, unit_diagonal=True),
        u_plan=trisolve_plan(U, lower=False, unit_diagonal=False),
        inv_perm_r=jnp.asarray(inv_pr),
        perm_c=jnp.asarray(lu.perm_c.astype(np.int32)),
        shape=A.shape,
        lu_nnz=int(lu.L.nnz + lu.U.nnz),
    )


def splu_solve(solver: SpluSolver, b):
    """``x = A⁻¹ b`` on device (jittable): gather → L-solve → U-solve →
    gather.  ``b`` is a vector (n,) or a multi-RHS panel (n, k)."""
    y = b[solver.inv_perm_r]
    y = ilu_apply((solver.l_plan, solver.u_plan), y)
    return y[solver.perm_c]
