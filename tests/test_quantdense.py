"""QuantDense (int8 per-row scales) and bf16 Dense pre-densified paths —
the pre-densified answer for the densify regime.

Accuracy bar: the reference's relative-error 0.1 policy
(blas_test.h:163-173); measured margins are ~1-2 orders tighter.
"""
import numpy as np
import jax.numpy as jnp

from sparsematrix_tpu.formats import CSR, Dense, QuantDense
from sparsematrix_tpu.ops.spmm import spmm, spmm_reference
from sparsematrix_tpu.ops.spmv import spmv_reference
from sparsematrix_tpu.utils.testutils import gen_random_dense_sparse


def _setup(rng, n=256, k=64, density=0.05):
    dense = gen_random_dense_sparse(rng, n, n, density=density)
    A = CSR.fromdense(dense)
    X = rng.standard_normal((n, k)).astype(np.float32)
    return dense, A, X


def test_dense_bf16_spmm(rng):
    dense, A, X = _setup(rng)
    Db = Dense.from_sparse(A, dtype=jnp.bfloat16)
    assert Db.data.dtype == jnp.bfloat16
    got = np.asarray(spmm(Db, jnp.asarray(X)))
    assert got.dtype == np.float32
    want = dense.astype(np.float64) @ X
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 0.02, rel


def test_quantdense_spmm(rng):
    dense, A, X = _setup(rng)
    Q = QuantDense.from_sparse(A)
    assert Q.data.dtype == jnp.int8 and Q.nnz == A.nnz
    got = np.asarray(spmm(Q, jnp.asarray(X)))
    want = dense.astype(np.float64) @ X
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 0.02, rel
    # dispatch goes through spmm_reference too
    got2 = np.asarray(spmm_reference(Q, jnp.asarray(X)))
    np.testing.assert_allclose(got, got2, rtol=1e-6)


def test_quantdense_spmv_and_todense(rng):
    dense, A, X = _setup(rng)
    Q = QuantDense.from_sparse(A)
    got = np.asarray(spmv_reference(Q, jnp.asarray(X[:, 0])))
    want = dense.astype(np.float64) @ X[:, 0]
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 0.02, rel
    back = np.asarray(Q.todense())
    relq = np.abs(back - dense).max() / np.abs(dense).max()
    assert relq < 1.0 / 127, relq


def test_quantdense_zero_rows(rng):
    dense = np.zeros((64, 64), np.float32)
    dense[1, 2] = 100.0
    Q = QuantDense.fromdense(dense)
    x = jnp.asarray(rng.standard_normal(64).astype(np.float32))
    got = np.asarray(spmv_reference(Q, x))
    want = dense @ np.asarray(x)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-3)
