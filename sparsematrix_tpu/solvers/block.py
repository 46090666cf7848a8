"""Block Krylov: conjugate gradients for multiple right-hand sides.

Block CG (O'Leary 1980) advances all k right-hand sides through ONE
Krylov space: each iteration is one SpMM (any ``spmm`` route — CSR,
strips or pre-dense bands), two (n,k)ᵀ(n,k) Gram products, and two k×k
solves — so k solves cost roughly one
solve's memory traffic per iteration, and shared spectral information
typically LOWERS the iteration count vs running k independent CGs.

Pairs with the multi-RHS preconditioner path: ``M`` may be an
``ilu_apply``/``ic_apply`` partial — the (n, k) residual panel solves
its columns through one vmapped triangular solve.

No reference analogue (the reference has no solver layer); this is the
idiomatic way to serve many simultaneous systems.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import spmm

__all__ = ["block_cg", "BlockSolveResult"]

_PREC = jax.lax.Precision.HIGHEST


class BlockSolveResult(NamedTuple):
    x: jnp.ndarray  # (n, k)
    iters: jnp.ndarray  # int32
    residuals: jnp.ndarray  # (k,) final per-column |r_j|


def _as_linop_mm(A) -> Callable:
    if callable(A):
        return A
    return lambda V: spmm(A, V)


def _gram(U, V):
    """(k,k) = Uᵀ V at HIGHEST precision (DEFAULT may run fp32 as TF32 —
    a Gram matrix built at ~3 digits stalls the recurrences)."""
    return jnp.matmul(U.T, V, precision=_PREC)


def block_cg(A, B, X0=None, tol: float = 1e-6, maxiter: int = 1000,
             M: Optional[Callable] = None,
             reg: float = 1e-12) -> BlockSolveResult:
    """Block CG for SPD ``A`` and a right-hand-side panel ``B`` (n, k).

    ``M`` is a panel preconditioner ``R -> M⁻¹ R`` (e.g. an ``ic_apply``
    partial over wave plans).  Stops when EVERY column satisfies
    ``|r_j| ≤ tol·|b_j|``.  ``reg`` regularizes the k×k systems once
    columns converge (their directions go rank-deficient)."""
    matmat = _as_linop_mm(A)
    precond = M if M is not None else (lambda R: R)
    k = B.shape[1]
    X = jnp.zeros_like(B) if X0 is None else X0
    R = B - matmat(X)
    Z = precond(R)
    P = Z
    G = _gram(R, Z)  # RᵀZ
    bnorm = jnp.maximum(jnp.linalg.norm(B, axis=0), 1e-30)
    eye = jnp.eye(k, dtype=B.dtype)

    def _solve_kxk(S, T):
        return jnp.linalg.solve(S + reg * eye, T)

    def cond(state):
        X, R, P, G, it = state
        res = jnp.linalg.norm(R, axis=0)
        return jnp.logical_and(it < maxiter, jnp.any(res / bnorm > tol))

    def body(state):
        X, R, P, G, it = state
        Q = matmat(P)
        alpha = _solve_kxk(_gram(P, Q), G)  # (PᵀAP)⁻¹ RᵀZ
        X = X + jnp.matmul(P, alpha, precision=_PREC)
        R = R - jnp.matmul(Q, alpha, precision=_PREC)
        Z = precond(R)
        G_new = _gram(R, Z)
        beta = _solve_kxk(G, G_new)
        P = Z + jnp.matmul(P, beta, precision=_PREC)
        return (X, R, P, G_new, it + 1)

    X, R, P, G, it = jax.lax.while_loop(cond, body, (X, R, P, G, 0))
    return BlockSolveResult(x=X, iters=it,
                            residuals=jnp.linalg.norm(R, axis=0))
