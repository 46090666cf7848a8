"""Triangular solve and ILU(0) vs scipy oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import (
    ilu0,
    ilu0_plans,
    ilu_apply,
    spmv,
    trisolve,
    trisolve_apply,
    trisolve_plan,
)


def _rand_lower(rng, n, density=0.2, unit=False):
    m = np.tril(rng.uniform(-1, 1, (n, n)) * (rng.random((n, n)) < density), -1)
    d = np.ones(n) if unit else rng.uniform(1.0, 2.0, n)
    return (m + np.diag(d)).astype(np.float32)


@pytest.mark.parametrize("n", [16, 64, 150])
def test_trisolve_lower(rng, n):
    L = _rand_lower(rng, n)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    x = np.asarray(trisolve(CSR.fromdense(L), jnp.asarray(b), lower=True))
    oracle = spla.spsolve_triangular(sp.csr_matrix(L), b, lower=True)
    np.testing.assert_allclose(x, oracle, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [16, 100])
def test_trisolve_upper(rng, n):
    U = _rand_lower(rng, n).T.copy()
    b = rng.uniform(-1, 1, n).astype(np.float32)
    x = np.asarray(trisolve(CSR.fromdense(U), jnp.asarray(b), lower=False))
    oracle = spla.spsolve_triangular(sp.csr_matrix(U), b, lower=False)
    np.testing.assert_allclose(x, oracle, rtol=1e-3, atol=1e-3)


def test_trisolve_plan_jit_reuse(rng):
    n = 40
    L = _rand_lower(rng, n)
    plan = trisolve_plan(CSR.fromdense(L), lower=True)
    f = jax.jit(trisolve_apply)
    b1 = rng.uniform(-1, 1, n).astype(np.float32)
    b2 = rng.uniform(-1, 1, n).astype(np.float32)
    for b in (b1, b2):
        x = np.asarray(f(plan, jnp.asarray(b)))
        np.testing.assert_allclose(L @ x, b, rtol=1e-3, atol=1e-3)


def test_trisolve_diagonal_matrix(rng):
    d = rng.uniform(1, 2, 8).astype(np.float32)
    A = CSR.fromdense(np.diag(d))
    b = rng.uniform(-1, 1, 8).astype(np.float32)
    x = np.asarray(trisolve(A, jnp.asarray(b)))
    np.testing.assert_allclose(x, b / d, rtol=1e-5)


def test_trisolve_zero_diag_raises(rng):
    m = np.eye(4, dtype=np.float32)
    m[2, 2] = 0.0
    with pytest.raises(ValueError):
        trisolve_plan(CSR.fromdense(m))


def _spd_banded(rng, n, density=0.15):
    """Diagonally dominant sparse matrix (ILU-friendly)."""
    m = (rng.random((n, n)) < density) * rng.uniform(-1, 1, (n, n))
    m = m.astype(np.float32)
    np.fill_diagonal(m, np.abs(m).sum(axis=1) + 1.0)
    return m


@pytest.mark.parametrize("n", [24, 80])
def test_ilu0_factors_match_on_pattern(rng, n):
    """On A's pattern, (L@U) must equal A wherever A is nonzero."""
    a = _spd_banded(rng, n)
    A = CSR.fromdense(a)
    L, U = ilu0(A)
    lu = np.asarray(L.todense()).astype(np.float64) @ np.asarray(U.todense())
    mask = a != 0
    np.testing.assert_allclose(lu[mask], a[mask], rtol=1e-3, atol=1e-3)


def test_ilu0_preconditioner_reduces_residual(rng):
    n = 60
    a = _spd_banded(rng, n, density=0.1)
    A = CSR.fromdense(a)
    plans = ilu0_plans(A)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    x = np.asarray(ilu_apply(plans, jnp.asarray(b)))
    # M x = b with M ≈ A → residual of A x vs b much smaller than |b|
    res = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    assert res < 0.5, res


def test_ilu0_exact_when_pattern_full_tri(rng):
    """If A's pattern admits exact LU (e.g. tridiagonal), ILU(0) == LU and
    the preconditioner solves exactly."""
    n = 50
    d = rng.uniform(2, 3, n)
    e = rng.uniform(-1, 1, n - 1)
    a = (np.diag(d) + np.diag(e, -1) + np.diag(e, 1)).astype(np.float32)
    A = CSR.fromdense(a)
    plans = ilu0_plans(A)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    x = np.asarray(ilu_apply(plans, jnp.asarray(b)))
    np.testing.assert_allclose(a @ x, b, rtol=1e-2, atol=1e-2)


def test_ilu0_native_matches_python_bit_exact(rng):
    """Native C++ IKJ vs the Python walk — bit-exact (the reference's
    optimized-vs-naive lesson, SURVEY §6)."""
    import pytest
    import scipy.sparse as sps

    from sparsematrix_tpu import native
    from sparsematrix_tpu.ops import ilu as ilu_mod

    if native.get_lib() is None:
        pytest.skip("native codec unavailable")
    n = 400
    d = sps.random(n, n, density=0.02, random_state=3, format="csr",
                   dtype=np.float64)
    d = d + sps.eye(n, format="csr") * 25.0
    d.sort_indices()
    a1 = np.ascontiguousarray(d.data, np.float64).copy()
    assert ilu_mod._ilu0_factor_native(d.indptr, d.indices, a1, n)
    a2 = d.data.astype(np.float64).copy()
    ilu_mod._ilu0_factor_python(d.indptr, d.indices, a2, n)
    np.testing.assert_array_equal(a1, a2)


# ---------------------------------------------------------------------------
# Fixed-point (nilpotent Jacobi) trisolve
# ---------------------------------------------------------------------------

from sparsematrix_tpu.ops import (  # noqa: E402
    ilu0_fixpoint_plans,
    trisolve_fixpoint_apply,
    trisolve_fixpoint_plan,
)


@pytest.mark.parametrize("n", [16, 64, 150])
@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_fixpoint_exact(rng, n, lower):
    M = _rand_lower(rng, n)
    if not lower:
        M = M.T.copy()
    b = rng.uniform(-1, 1, n).astype(np.float32)
    plan = trisolve_fixpoint_plan(CSR.fromdense(M), lower=lower)
    x = np.asarray(trisolve_fixpoint_apply(plan, jnp.asarray(b)))
    oracle = spla.spsolve_triangular(sp.csr_matrix(M), b, lower=lower)
    np.testing.assert_allclose(x, oracle, rtol=1e-3, atol=1e-3)


def test_trisolve_fixpoint_unit_diag(rng):
    n = 48
    L = _rand_lower(rng, n, unit=True)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    plan = trisolve_fixpoint_plan(CSR.fromdense(L), lower=True,
                                  unit_diagonal=True)
    x = np.asarray(trisolve_fixpoint_apply(plan, jnp.asarray(b)))
    np.testing.assert_allclose(L @ x, b, rtol=1e-3, atol=1e-3)


def test_trisolve_fixpoint_diagonal_only(rng):
    d = rng.uniform(1, 2, 8).astype(np.float32)
    plan = trisolve_fixpoint_plan(CSR.fromdense(np.diag(d)), lower=True)
    assert plan.n_iters == 0
    b = rng.uniform(-1, 1, 8).astype(np.float32)
    x = np.asarray(trisolve_fixpoint_apply(plan, jnp.asarray(b)))
    np.testing.assert_allclose(x, b / d, rtol=1e-5)


def test_trisolve_fixpoint_jittable(rng):
    n = 40
    L = _rand_lower(rng, n)
    plan = trisolve_fixpoint_plan(CSR.fromdense(L), lower=True)
    f = jax.jit(trisolve_fixpoint_apply)
    for _ in range(2):
        b = rng.uniform(-1, 1, n).astype(np.float32)
        x = np.asarray(f(plan, jnp.asarray(b)))
        np.testing.assert_allclose(L @ x, b, rtol=1e-3, atol=1e-3)


def test_trisolve_fixpoint_truncated_is_linear_fixed_op(rng):
    """Truncated n_iters must still be a fixed LINEAR operator in b
    (the property a preconditioner needs)."""
    n = 64
    L = _rand_lower(rng, n)
    plan = trisolve_fixpoint_plan(CSR.fromdense(L), lower=True, n_iters=3)
    b1 = rng.uniform(-1, 1, n).astype(np.float32)
    b2 = rng.uniform(-1, 1, n).astype(np.float32)
    f = lambda b: np.asarray(trisolve_fixpoint_apply(plan, jnp.asarray(b)))
    np.testing.assert_allclose(
        f(b1 + 2 * b2), f(b1) + 2 * f(b2), rtol=1e-3, atol=1e-3
    )


def test_ilu_fixpoint_cg_poisson(rng):
    """ILU(0) fixed-point preconditioner must beat plain CG on Poisson."""
    from sparsematrix_tpu.solvers import cg

    side = 16
    n = side * side
    Iq = sp.eye(side)
    T = sp.diags([-1, 4, -1], [-1, 0, 1], (side, side))
    Apo = (sp.kron(Iq, T)
           + sp.kron(sp.diags([-1, -1], [-1, 1], (side, side)), Iq)).tocsr()
    A = CSR.from_scipy(Apo.astype(np.float32))
    b = rng.standard_normal(n).astype(np.float32)
    plans = ilu0_fixpoint_plans(A)
    M = lambda r: ilu_apply(plans, r)
    x_pre = np.asarray(cg(A, jnp.asarray(b), maxiter=12, M=M, tol=0.0).x)
    x_plain = np.asarray(cg(A, jnp.asarray(b), maxiter=12, tol=0.0).x)
    r_pre = np.linalg.norm(Apo @ x_pre - b)
    r_plain = np.linalg.norm(Apo @ x_plain - b)
    assert r_pre < 0.5 * r_plain


# ---------------------------------------------------------------------------
# Level-scheduled plan + scan, driven directly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 64, 150])
@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_level_exact(rng, n, lower):
    M = _rand_lower(rng, n)
    if not lower:
        M = M.T.copy()
    b = rng.uniform(-1, 1, n).astype(np.float32)
    plan = trisolve_plan(CSR.fromdense(M), lower=lower)
    x = np.asarray(trisolve_apply(plan, jnp.asarray(b)))
    oracle = spla.spsolve_triangular(sp.csr_matrix(M), b, lower=lower)
    np.testing.assert_allclose(x, oracle, rtol=1e-3, atol=1e-3)


def test_trisolve_level_jit_and_unit_diag(rng):
    n = 130
    L = _rand_lower(rng, n, unit=True)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    plan = trisolve_plan(CSR.fromdense(L), lower=True,
                               unit_diagonal=True)
    f = jax.jit(trisolve_apply)
    x = np.asarray(f(plan, jnp.asarray(b)))
    np.testing.assert_allclose(L @ x, b, rtol=1e-3, atol=1e-3)
    # new RHS reuses the compiled plan
    b2 = rng.uniform(-1, 1, n).astype(np.float32)
    x2 = np.asarray(f(plan, jnp.asarray(b2)))
    np.testing.assert_allclose(L @ x2, b2, rtol=1e-3, atol=1e-3)


def test_trisolve_level_diagonal_only(rng):
    d = rng.uniform(1, 2, 8).astype(np.float32)
    A = CSR.fromdense(np.diag(d))
    b = rng.uniform(-1, 1, 8).astype(np.float32)
    plan = trisolve_plan(A, lower=True)
    x = np.asarray(trisolve_apply(plan, jnp.asarray(b)))
    np.testing.assert_allclose(x, b / d, rtol=1e-5)


def test_trisolve_level_deep_chain(rng):
    # bidiagonal: n levels of width 1 — the worst case for level padding
    n = 40
    L = (np.diag(rng.uniform(1, 2, n))
         + np.diag(rng.uniform(-1, 1, n - 1), -1)).astype(np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    plan = trisolve_plan(CSR.fromdense(L), lower=True)
    assert plan.rows.shape == (n, 1)  # n levels of width 1
    x = np.asarray(trisolve_apply(plan, jnp.asarray(b)))
    oracle = spla.spsolve_triangular(sp.csr_matrix(L), b, lower=True)
    np.testing.assert_allclose(x, oracle, rtol=1e-3, atol=1e-3)


def test_ilu_level_plans_cg_poisson(rng):
    """Level-scheduled ILU(0) plans precondition CG like the fixed-point
    family."""
    from sparsematrix_tpu.solvers import cg

    side = 16
    n = side * side
    Iq = sp.eye(side)
    T = sp.diags([-1, 4, -1], [-1, 0, 1], (side, side))
    Apo = (sp.kron(Iq, T)
           + sp.kron(sp.diags([-1, -1], [-1, 1], (side, side)), Iq)).tocsr()
    A = CSR.from_scipy(Apo.astype(np.float32))
    b = rng.standard_normal(n).astype(np.float32)
    plans = ilu0_plans(A)
    M = lambda r: ilu_apply(plans, r)
    x_pre = np.asarray(cg(A, jnp.asarray(b), maxiter=12, M=M, tol=0.0).x)
    x_plain = np.asarray(cg(A, jnp.asarray(b), maxiter=12, tol=0.0).x)
    r_pre = np.linalg.norm(Apo @ x_pre - b)
    r_plain = np.linalg.norm(Apo @ x_plain - b)
    assert r_pre < 0.5 * r_plain
