"""SpMV/SpMM vs dense oracle for every format, under jit.

Differential-oracle strategy from the reference harness
(reference src/test/blas_test.h:240-246): compute on the sparse path,
check against the densified operand's dense product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrix_tpu.formats import (
    BSR,
    COO,
    CSR,
    ELL,
    CodebookCSR,
    csr_to_blocked_ell,
)
from sparsematrix_tpu.ops import spmv, spmm
from sparsematrix_tpu.utils.testutils import (
    gen_matrix_random,
    gen_random_dense_sparse,
    gen_sparse_index_matrix,
)

SHAPES = [(16, 16), (117, 63), (128, 256)]


def _formats(dense):
    yield COO.fromdense(dense)
    yield CSR.fromdense(dense)
    yield ELL.fromdense(dense)
    yield BSR.fromdense(dense, block_shape=(8, 8))
    yield csr_to_blocked_ell(CSR.fromdense(dense), block_shape=(8, 64))


@pytest.mark.parametrize("shape", SHAPES)
def test_spmv_all_formats(rng, shape):
    dense = gen_random_dense_sparse(rng, *shape, density=0.25)
    x = gen_matrix_random(rng, shape[1], 1)[:, 0]
    oracle = dense.astype(np.float64) @ x.astype(np.float64)
    for A in _formats(dense):
        y = np.asarray(jax.jit(spmv)(A, jnp.asarray(x)))
        np.testing.assert_allclose(y, oracle, rtol=2e-3, atol=0.5,
                                   err_msg=type(A).__name__)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [1, 32, 100])
def test_spmm_all_formats(rng, shape, k):
    dense = gen_random_dense_sparse(rng, *shape, density=0.25)
    X = gen_matrix_random(rng, shape[1], k)
    oracle = dense.astype(np.float64) @ X.astype(np.float64)
    for A in _formats(dense):
        Y = np.asarray(jax.jit(spmm)(A, jnp.asarray(X)))
        np.testing.assert_allclose(Y, oracle, rtol=2e-3, atol=0.5,
                                   err_msg=type(A).__name__)


def test_spmv_codebook(rng):
    idx_mtx, table = gen_sparse_index_matrix(rng, 60, 90, density=0.25, table_size=63)
    A = CodebookCSR.from_index_matrix(idx_mtx, table)
    dense = np.asarray(A.todense())
    x = gen_matrix_random(rng, 90, 1)[:, 0]
    y = np.asarray(jax.jit(spmv)(A, jnp.asarray(x)))
    np.testing.assert_allclose(y, dense.astype(np.float64) @ x, rtol=2e-3, atol=0.5)


def test_empty_rows_and_cols(rng):
    dense = np.zeros((10, 12), dtype=np.float32)
    dense[3, 4] = 2.5
    dense[3, 11] = -1.0
    x = np.arange(12, dtype=np.float32)
    for A in _formats(dense):
        y = np.asarray(spmv(A, jnp.asarray(x)))
        np.testing.assert_allclose(y, dense @ x, atol=1e-6, err_msg=type(A).__name__)


def test_all_zero_matrix():
    dense = np.zeros((8, 8), dtype=np.float32)
    A = CSR.fromdense(dense)
    y = np.asarray(spmv(A, jnp.ones(8, jnp.float32)))
    np.testing.assert_array_equal(y, np.zeros(8))
