"""Misc coverage: spmm_right, CSC, ELL truncation, stored_density, config."""
import jax
import jax.numpy as jnp
import numpy as np

from sparsematrix_tpu.formats import CSC, CSR, ELL, csr_to_blocked_ell
from sparsematrix_tpu.ops import spmm_right
from sparsematrix_tpu.utils.testutils import (
    gen_matrix_random,
    gen_random_dense_sparse,
)


def test_spmm_right(rng):
    """X @ A with A stored pre-transposed (the reference's SblasTrans)."""
    k, n = 40, 30
    a_dense = gen_random_dense_sparse(rng, k, n, density=0.3)
    X = gen_matrix_random(rng, 7, k)
    A_t = CSR.fromdense(a_dense.T)  # store A^T
    got = np.asarray(spmm_right(jnp.asarray(X), A_t))
    np.testing.assert_allclose(got, X.astype(np.float64) @ a_dense,
                               rtol=2e-3, atol=0.5)


def test_csc_is_csr_of_transpose(rng):
    dense = gen_random_dense_sparse(rng, 12, 18, density=0.4)
    csc = CSC.fromdense(dense)
    np.testing.assert_array_equal(np.asarray(csc.todense()), dense.T)


def test_ell_row_capacity_truncates(rng):
    dense = gen_random_dense_sparse(rng, 10, 20, density=0.5)
    import pytest

    with pytest.raises(ValueError):  # silent truncation is an error now
        ELL.fromdense(dense, row_capacity=3)
    ell = ELL.fromdense(dense, row_capacity=3, truncate=True)
    assert ell.row_capacity == 3
    # decode keeps at most 3 entries per row, and nnz counts stored entries
    out = np.asarray(ell.todense())
    assert ((out != 0).sum(axis=1) <= 3).all()
    assert ell.nnz == int(np.minimum((dense != 0).sum(axis=1), 3).sum())


def test_blocked_ell_stored_density(rng):
    dense = gen_random_dense_sparse(rng, 64, 256, density=0.02)
    bell = csr_to_blocked_ell(CSR.fromdense(dense), block_shape=(8, 64))
    assert 0 < bell.stored_density <= 1.0


def test_config_forcing():
    from sparsematrix_tpu.config import Config

    # the platform rule: the ragged halo exchange on the GPU only
    assert Config(_backend="gpu").ragged_halo()
    assert not Config(_backend="cpu").ragged_halo()
    assert Config(_backend="cpu").backend == "cpu"


def test_repr_and_allclose(rng):
    dense = gen_random_dense_sparse(rng, 6, 6, density=0.5)
    A = CSR.fromdense(dense)
    B = CSR.fromdense(dense, capacity=50)
    assert A.allclose(B)
    assert "CSR" in repr(A)
    assert A.nrows == 6 and A.ncols == 6
