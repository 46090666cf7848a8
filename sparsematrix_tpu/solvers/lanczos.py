"""Lanczos tridiagonalization + extremal eigenvalues for symmetric sparse A.

``lanczos`` runs k steps with full reorthogonalization (a ``lax.scan`` —
fixed trip count, a (k, n) basis panel); ``eigsh_lanczos``
returns Ritz values/vectors of the leading tridiagonal block.  The dense
(k, k) tridiagonal eigenproblem runs through ``jnp.linalg.eigh`` — k is
small by construction.

Built on ``ops.spmv`` so every format drives it.  The reference has no solver layer; this rounds out the
spectral corner of the north-star surface (PageRank/Poisson examples
already exercise power iteration and CG).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from ..ops import spmv

__all__ = ["lanczos", "eigsh_lanczos", "LanczosResult"]


class LanczosResult(NamedTuple):
    alphas: jnp.ndarray  # (k,) diagonal of T
    betas: jnp.ndarray  # (k-1,) off-diagonal of T
    V: jnp.ndarray  # (k, n) orthonormal Lanczos basis (rows)


def _as_linop(A) -> Callable:
    if callable(A):
        return A
    return lambda v: spmv(A, v)


def lanczos(A, v0, k: int, reorth: bool = True) -> LanczosResult:
    """k-step Lanczos on symmetric ``A`` from start vector ``v0``.

    ``reorth=True`` re-projects against the full basis each step (classic
    one-pass full reorthogonalization — one (k, n) matmul per step); ``False`` is the textbook
    three-term recurrence.
    """
    matvec = _as_linop(A)
    n = v0.shape[0]
    v = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)
    V0 = jnp.zeros((k, n), v0.dtype).at[0].set(v)

    def step(carry, i):
        V, v_prev, v_cur, beta_prev = carry
        w = matvec(v_cur) - beta_prev * v_prev
        alpha = jnp.vdot(v_cur, w)
        w = w - alpha * v_cur
        if reorth:
            # project out every basis vector built so far (rows ≥ i+1 are
            # zero, so the panel product is safely masked by construction)
            w = w - V.T @ (V @ w)
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.maximum(beta, 1e-30)
        V = jax.lax.cond(
            i + 1 < k,
            lambda V: V.at[i + 1].set(v_next),
            lambda V: V,
            V,
        )
        return (V, v_cur, v_next, beta), (alpha, beta)

    (V, _, _, _), (alphas, betas) = jax.lax.scan(
        step, (V0, jnp.zeros_like(v), v, jnp.asarray(0.0, v.dtype)),
        jnp.arange(k),
    )
    return LanczosResult(alphas=alphas, betas=betas[:-1], V=V)


def eigsh_lanczos(A, v0, k: int = 32, reorth: bool = True
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ritz values (ascending) and vectors from k Lanczos steps.

    Returns ``(theta (k,), Y (k, n))`` with ``Y[j] ≈`` the eigenvector for
    ``theta[j]``; the extremal entries converge first (use
    ``theta[0]``/``theta[-1]`` for λ_min/λ_max estimates).
    """
    res = lanczos(A, v0, k, reorth=reorth)
    T = (jnp.diag(res.alphas)
         + jnp.diag(res.betas, 1)
         + jnp.diag(res.betas, -1))
    theta, S = jnp.linalg.eigh(T)
    Y = S.T @ res.V  # (k, n) Ritz vectors as rows
    return theta, Y
