"""Triangular solves on the level-scan and fixed-point engines: lower/upper
× unit/non-unit diagonal × vector/panel right-hand side, on ILU(0)
factors of a Poisson matrix, deep chains, random triangles and diagonal-
only matrices, against scipy in float64; and gradients with respect to b
and to the stored values, against central finite differences."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import (ilu0, trisolve, trisolve_apply,
                                  trisolve_fixpoint_apply,
                                  trisolve_fixpoint_plan, trisolve_plan)


def _poisson_ilu_lower(rng):
    side = 8
    t = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (side, side))
    off = sp.diags([-1.0, -1.0], [-1, 1], (side, side))
    A = (sp.kron(sp.eye(side), t) + sp.kron(off, sp.eye(side))).tocsr()
    L, U = ilu0(CSR.from_scipy(A.astype(np.float32)))
    low = sp.tril(L.to_scipy(), k=-1).toarray()
    return low, U.to_scipy().diagonal()


def _chain_lower(rng, n=40):
    return np.diag(rng.uniform(-1, 1, n - 1), -1), rng.uniform(1, 2, n)


def _random_lower(rng, n=50):
    m = rng.uniform(-1, 1, (n, n)) * (rng.random((n, n)) < 0.2)
    return np.tril(m, -1), rng.uniform(1, 2, n)


def _diagonal_only(rng, n=20):
    return np.zeros((n, n)), rng.uniform(1, 2, n)


MATRICES = {"poisson-ilu": _poisson_ilu_lower, "deep-chain": _chain_lower,
            "random": _random_lower, "diagonal-only": _diagonal_only}


def _triangle(kind, lower, unit, seed=0):
    """(dense float32 triangle, its scipy CSR in float64)."""
    strict, diag = MATRICES[kind](np.random.default_rng(seed))
    tri = strict + np.diag(np.ones_like(diag) if unit else diag)
    tri = (tri if lower else tri.T).astype(np.float32)
    return tri, sp.csr_matrix(tri.astype(np.float64))


def _solve(engine, tri, b, lower, unit):
    A = CSR.fromdense(tri)
    if engine == "level":
        return trisolve(A, b, lower=lower, unit_diagonal=unit)
    plan = trisolve_fixpoint_plan(A, lower=lower, unit_diagonal=unit)
    if b.ndim == 2:
        return jax.vmap(lambda c: trisolve_fixpoint_apply(plan, c),
                        in_axes=1, out_axes=1)(b)
    return trisolve_fixpoint_apply(plan, b)


@pytest.mark.parametrize("rhs", ["vector", "panel"])
@pytest.mark.parametrize("unit", [False, True], ids=["nonunit", "unit"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("kind", list(MATRICES))
@pytest.mark.parametrize("engine", ["level", "fixpoint"])
def test_trisolve_sweep(engine, kind, lower, unit, rhs):
    tri, ref = _triangle(kind, lower, unit)
    n = tri.shape[0]
    shape = (n,) if rhs == "vector" else (n, 3)
    b = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    x = np.asarray(_solve(engine, tri, jnp.asarray(b), lower, unit))
    want = spla.spsolve_triangular(ref, b.astype(np.float64), lower=lower)
    assert x.shape == want.shape
    np.testing.assert_allclose(x, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _central_difference(f, v, idx, h):
    e = np.zeros(v.shape, np.float32)
    e[idx] = h
    return (float(f(jnp.asarray(v + e))) - float(f(jnp.asarray(v - e)))) / (
        2 * h)


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("engine", ["level", "fixpoint"])
def test_trisolve_grad_b(engine, lower):
    tri, _ = _triangle("random", lower, unit=False)
    A = CSR.fromdense(tri)
    n = tri.shape[0]
    g = np.random.default_rng(2)
    b = g.uniform(-1, 1, n).astype(np.float32)
    w = jnp.asarray(g.uniform(-1, 1, n).astype(np.float32))
    if engine == "level":
        plan = trisolve_plan(A, lower=lower)
        loss = lambda bb: jnp.vdot(w, trisolve_apply(plan, bb))
    else:
        plan = trisolve_fixpoint_plan(A, lower=lower)
        loss = lambda bb: jnp.vdot(w, trisolve_fixpoint_apply(plan, bb))
    grad = np.asarray(jax.grad(loss)(jnp.asarray(b)))
    for i in (0, n // 2, n - 1):  # the loss is linear in b
        np.testing.assert_allclose(grad[i], _central_difference(loss, b, i,
                                                                0.5),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("engine", ["level", "fixpoint"])
def test_trisolve_grad_values(engine, lower):
    """d<w, T⁻¹b>/d(stored off-diagonal values), at stored entries."""
    tri, _ = _triangle("random", lower, unit=False)
    A = CSR.fromdense(tri)
    n = tri.shape[0]
    g = np.random.default_rng(3)
    b = jnp.asarray(g.uniform(-1, 1, n).astype(np.float32))
    w = jnp.asarray(g.uniform(-1, 1, n).astype(np.float32))
    if engine == "level":
        plan = trisolve_plan(A, lower=lower)
        vals0 = np.asarray(plan.offdiag_vals)
        loss = lambda v: jnp.vdot(w, trisolve_apply(
            dataclasses.replace(plan, offdiag_vals=v), b))
    else:
        plan = trisolve_fixpoint_plan(A, lower=lower)
        vals0 = np.asarray(plan.e.data)
        loss = lambda v: jnp.vdot(w, trisolve_fixpoint_apply(
            dataclasses.replace(plan, e=dataclasses.replace(plan.e, data=v)),
            b))
    grad = np.asarray(jax.grad(loss)(jnp.asarray(vals0)))
    stored = np.argwhere(vals0 != 0)
    assert len(stored) > 10
    for idx in map(tuple, stored[:: max(len(stored) // 6, 1)]):
        fd = _central_difference(loss, vals0, idx, 1e-2)
        np.testing.assert_allclose(grad[idx], fd, rtol=2e-2, atol=2e-3)
