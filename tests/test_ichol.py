"""IC(0) incomplete Cholesky: factorization properties + preconditioning."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import (
    ic0,
    ic0_fixpoint_plans,
    ic0_plans,
    ic_apply,
)
from sparsematrix_tpu.ops.ichol import _ic0_factor_python
from sparsematrix_tpu.solvers import cg


def _poisson2d(side):
    I = sp.eye(side)
    T = sp.diags([-1, 4, -1], [-1, 0, 1], (side, side))
    return (sp.kron(I, T)
            + sp.kron(sp.diags([-1, -1], [-1, 1], (side, side)), I)).tocsr()


def _spd_random(rng, n, density=0.1):
    """Random sparse SPD: B B^T structure + diagonal dominance."""
    B = sp.random(n, n, density=density, random_state=42, format="csr",
                  dtype=np.float64)
    A = (B @ B.T).tocsr()
    A = A + sp.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)
    return A.astype(np.float32).tocsr()


@pytest.mark.parametrize("n", [16, 80, 200])
def test_ic0_pattern_identity(rng, n):
    """(L L^T)[i,j] == A[i,j] at every stored position of tril(A) — the
    defining property of zero-fill incomplete Cholesky."""
    A = _spd_random(rng, n)
    L = ic0(CSR.from_scipy(A)).to_scipy().astype(np.float64)
    prod = (L @ L.T).tocsr()
    low = sp.tril(A, k=0).tocoo()
    got = np.asarray(prod[low.row, low.col]).ravel()
    np.testing.assert_allclose(got, low.data.astype(np.float64),
                               rtol=1e-5, atol=1e-5)


def test_ic0_exact_for_full_lower_pattern(rng):
    """When tril(A) is dense, IC(0) IS the exact Cholesky factor."""
    n = 24
    M = rng.uniform(-1, 1, (n, n))
    A = (M @ M.T + n * np.eye(n)).astype(np.float32)
    L = np.asarray(ic0(CSR.fromdense(A)).todense()).astype(np.float64)
    want = np.linalg.cholesky(A.astype(np.float64))
    np.testing.assert_allclose(L, want, rtol=1e-4, atol=1e-4)


def test_ic0_native_matches_python_bit_exact(rng):
    A = _spd_random(rng, 120)
    low = sp.tril(A, k=0).tocsr()
    low.sort_indices()
    a_py = low.data.astype(np.float64).copy()
    _ic0_factor_python(low.indptr.astype(np.int64), low.indices, a_py,
                       low.shape[0])
    got = ic0(CSR.from_scipy(A)).to_scipy()
    got.sort_indices()
    # ic0 stores at A's dtype; the walks themselves are fp64-bit-exact
    np.testing.assert_array_equal(got.data, a_py.astype(np.float32))


def test_ic0_missing_diagonal_raises():
    A = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 2.0]], np.float32))
    with pytest.raises(ValueError, match="diagonal"):
        ic0(CSR.from_scipy(A))


def test_ic0_non_spd_raises():
    A = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)  # indefinite
    with pytest.raises(ZeroDivisionError, match="pivot"):
        ic0(CSR.fromdense(A))


def test_ic0_reads_lower_triangle_only(rng):
    """Asymmetric upper entries must not change the factor."""
    A = _spd_random(rng, 60).toarray()
    B = A.copy()
    B[np.triu_indices_from(B, k=1)] *= 1.7  # corrupt the upper triangle
    L1 = np.asarray(ic0(CSR.fromdense(A)).todense())
    L2 = np.asarray(ic0(CSR.fromdense(B.astype(np.float32))).todense())
    np.testing.assert_array_equal(L1, L2)


@pytest.mark.parametrize("family", ["level-sched", "fixpoint",
                                    "fixpoint-padded"])
def test_ic_apply_solves_both_triangles(rng, family):
    """M⁻¹ r must equal (L L^T)⁻¹ r exactly (it's two exact solves)."""
    A = _spd_random(rng, 90)
    Ac = CSR.from_scipy(A)
    plans = {"level-sched": ic0_plans,
             "fixpoint": ic0_fixpoint_plans,
             # explicit-zero padding of E must not change the solve
             "fixpoint-padded": lambda M: ic0_fixpoint_plans(
                 M, capacity=A.nnz)}[family](Ac)
    L = ic0(Ac).to_scipy().astype(np.float64)
    r = rng.uniform(-1, 1, A.shape[0]).astype(np.float32)
    got = np.asarray(jax.jit(ic_apply)(plans, jnp.asarray(r)))
    import scipy.sparse.linalg as spla

    want = spla.spsolve_triangular(
        (L.T).tocsr(), spla.spsolve_triangular(L.tocsr(), r, lower=True),
        lower=False)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)


def test_ic0_cg_poisson_converges_faster(rng):
    """IC(0)-PCG on the 2-D Poisson system beats plain CG at a fixed
    iteration budget (the end-to-end value of the preconditioner)."""
    side = 24
    A = _poisson2d(side).astype(np.float32)
    n = A.shape[0]
    Ac = CSR.from_scipy(A)
    b = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))
    plans = ic0_plans(Ac)
    M = lambda r: ic_apply(plans, r)
    iters = 20
    x_plain = np.asarray(cg(Ac, b, maxiter=iters, tol=0.0).x)
    x_pcg = np.asarray(cg(Ac, b, maxiter=iters, tol=0.0, M=M).x)
    res_plain = np.linalg.norm(A @ x_plain - np.asarray(b))
    res_pcg = np.linalg.norm(A @ x_pcg - np.asarray(b))
    assert res_pcg < 0.2 * res_plain
