"""Sparse direct solve (SuperLU host factor + level-scan device solves)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import splu_plans, splu_solve


def _nonsym_system(rng, n, density=0.05):
    d = sp.random(n, n, density=density, random_state=11, format="csr",
                  dtype=np.float64)
    d.data = rng.uniform(-1, 1, d.nnz)
    d = d + sp.diags(rng.uniform(2.0, 4.0, n))  # nonsingular
    return d.tocsr()


@pytest.mark.parametrize("n", [50, 300])
def test_splu_solve_matches_spsolve(rng, n):
    P = _nonsym_system(rng, n)
    A = CSR.from_scipy(P.astype(np.float32))
    b = rng.uniform(-1, 1, n).astype(np.float32)
    solver = splu_plans(A)
    x = np.asarray(splu_solve(solver, jnp.asarray(b)), np.float64)
    want = spla.spsolve(P.tocsc(), b.astype(np.float64))
    np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-3)
    # residual-level check too (permutations/factors wired correctly)
    assert np.linalg.norm(P @ x - b) / np.linalg.norm(b) < 1e-3


def test_splu_solve_jits_and_reuses(rng):
    n = 120
    P = _nonsym_system(rng, n)
    A = CSR.from_scipy(P.astype(np.float32))
    solver = splu_plans(A)
    f = jax.jit(lambda s, bb: splu_solve(s, bb))
    for seed in (1, 2):
        b = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
        x = np.asarray(f(solver, jnp.asarray(b)), np.float64)
        assert np.linalg.norm(P @ x - b) / np.linalg.norm(b) < 1e-3


def test_splu_rejects_rectangular(rng):
    d = np.zeros((4, 6), np.float32)
    d[np.arange(4), np.arange(4)] = 1.0
    with pytest.raises(ValueError, match="square"):
        splu_plans(CSR.fromdense(d))


def test_splu_permuted_diagonal_system(rng):
    """A system whose natural ordering needs row pivoting: a shuffled
    permutation matrix plus noise — exercises perm_r/perm_c wiring."""
    n = 80
    perm = rng.permutation(n)
    P = sp.csr_matrix((rng.uniform(1.0, 2.0, n), (np.arange(n), perm)),
                      shape=(n, n), dtype=np.float64)
    P = P + 0.01 * sp.random(n, n, density=0.05, random_state=3)
    A = CSR.from_scipy(P.tocsr().astype(np.float32))
    b = rng.uniform(-1, 1, n).astype(np.float32)
    x = np.asarray(splu_solve(splu_plans(A), jnp.asarray(b)), np.float64)
    want = spla.spsolve(P.tocsc(), b.astype(np.float64))
    np.testing.assert_allclose(x, want, rtol=5e-3, atol=5e-3)
