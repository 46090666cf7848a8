"""Autodiff through sparse ops.

The framework is functional JAX: gradients flow through ``spmv``/``spmm``
with respect to both the dense operand and the sparse *values* (``A.data``
is a pytree leaf).  The reference, being a C++ inference library, has no
autodiff at all — a capability users expect from a JAX-native library.
"""
import jax
import jax.numpy as jnp
import numpy as np

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import spmm_reference, spmv_reference
from sparsematrix_tpu.utils.testutils import gen_random_dense_sparse


def test_grad_wrt_x(rng):
    dense = gen_random_dense_sparse(rng, 20, 30, density=0.3)
    A = CSR.fromdense(dense)
    x = jnp.asarray(rng.uniform(-1, 1, 30).astype(np.float32))

    def loss(x):
        return jnp.sum(spmv_reference(A, x) ** 2)

    g = np.asarray(jax.grad(loss)(x))
    # analytic: d/dx |Ax|^2 = 2 A^T A x
    want = 2 * dense.T @ (dense @ np.asarray(x))
    np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-3)


def test_grad_wrt_sparse_values(rng):
    dense = gen_random_dense_sparse(rng, 16, 16, density=0.4)
    A = CSR.fromdense(dense)
    x = jnp.asarray(rng.uniform(-1, 1, 16).astype(np.float32))
    y_bar = jnp.asarray(rng.uniform(-1, 1, 16).astype(np.float32))

    def loss(data):
        A2 = jax.tree_util.tree_map(lambda a: a, A)
        import dataclasses

        A2 = dataclasses.replace(A, data=data)
        return jnp.vdot(y_bar, spmv_reference(A2, x))

    g = np.asarray(jax.grad(loss)(A.data))
    # analytic: d/d a_ij <ybar, Ax> = ybar_i x_j at stored positions
    rid = np.asarray(A.row_ids)
    cid = np.asarray(A.indices)
    want = np.where(rid < 16, np.asarray(y_bar)[np.minimum(rid, 15)] *
                    np.asarray(x)[cid], 0.0)
    np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5)


def test_jvp_spmm(rng):
    dense = gen_random_dense_sparse(rng, 12, 18, density=0.3)
    A = CSR.fromdense(dense)
    X = jnp.asarray(rng.uniform(-1, 1, (18, 5)).astype(np.float32))
    dX = jnp.asarray(rng.uniform(-1, 1, (18, 5)).astype(np.float32))
    _, tangent = jax.jvp(lambda X: spmm_reference(A, X), (X,), (dX,))
    np.testing.assert_allclose(np.asarray(tangent), dense @ np.asarray(dX),
                               rtol=1e-4, atol=1e-4)


def test_codebook_matmul_grad(rng):
    import jax.numpy as jnp

    from sparsematrix_tpu.formats import CodebookDense
    from sparsematrix_tpu.ops import spmm_right
    from sparsematrix_tpu.utils.testutils import (
        gen_matrix_random,
        gen_sparse_index_matrix,
    )

    m, n, k = 8, 128, 256
    a = jnp.asarray(gen_matrix_random(rng, m, k) / 1000)
    idx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                         table_size=31)
    b_t = CodebookDense.from_index_matrix(idx, table, trans=True)
    g = np.asarray(jax.grad(lambda a: jnp.sum(spmm_right(a, b_t) ** 2))(a))
    B = np.asarray(b_t.todense()).T
    want = 2 * (np.asarray(a) @ B) @ B.T
    np.testing.assert_allclose(g, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# VJPs through the block and row-padded formats (values and dense operand)
# ---------------------------------------------------------------------------


def test_bell_kernel_vjp(rng):
    from sparsematrix_tpu.formats import csr_to_blocked_ell

    dense = gen_random_dense_sparse(rng, 64, 256, density=0.1)
    bell = csr_to_blocked_ell(CSR.fromdense(dense), block_shape=(8, 64))
    X = jnp.asarray(rng.standard_normal((256, 16)).astype(np.float32))
    g = jnp.asarray(rng.standard_normal((64, 16)).astype(np.float32))
    y, vjp = jax.vjp(spmm_reference, bell, X)
    dA, dX = vjp(g)
    np.testing.assert_allclose(np.asarray(dX),
                               dense.T.astype(np.float64) @ np.asarray(g),
                               rtol=2e-3, atol=0.5)
    # block-gradient bilinear check: <dblocks, blocks> == <g, A@X>
    got = float(jnp.sum(dA.blocks * bell.blocks))
    want = float(np.sum(np.asarray(g) * (dense @ np.asarray(X))))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2.0)


def test_bsr_kernel_vjp(rng):
    from sparsematrix_tpu.formats import csr_to_bsr

    dense = gen_random_dense_sparse(rng, 64, 128, density=0.15)
    bsr = csr_to_bsr(CSR.fromdense(dense), block_shape=(8, 8))
    X = jnp.asarray(rng.standard_normal((128, 16)).astype(np.float32))
    g = jnp.asarray(rng.standard_normal((64, 16)).astype(np.float32))
    y, vjp = jax.vjp(spmm_reference, bsr, X)
    dA, dX = vjp(g)
    np.testing.assert_allclose(np.asarray(dX),
                               dense.T.astype(np.float64) @ np.asarray(g),
                               rtol=2e-3, atol=0.5)
    got = float(jnp.sum(dA.data * bsr.data))
    want = float(np.sum(np.asarray(g) * (dense @ np.asarray(X))))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2.0)


def test_rowpure_kernel_vjp(rng):
    from sparsematrix_tpu.formats import ELL

    dense = gen_random_dense_sparse(rng, 80, 2048, density=0.05)
    packed = ELL.fromdense(dense)  # row-padded: one row per ELL row
    x = jnp.asarray(rng.standard_normal(2048).astype(np.float32))
    g = jnp.asarray(rng.standard_normal(80).astype(np.float32))
    y, vjp = jax.vjp(spmv_reference, packed, x)
    dp, gx = vjp(g)
    np.testing.assert_allclose(np.asarray(gx),
                               dense.T.astype(np.float64) @ np.asarray(g),
                               rtol=2e-3, atol=0.5)
    got = float(jnp.sum(dp.data * packed.data))
    want = float(np.sum(np.outer(np.asarray(g), np.asarray(x)) * dense))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2.0)
