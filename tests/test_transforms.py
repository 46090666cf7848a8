"""JAX transform coverage: vmap over RHS batches, bf16 data, scan-compat.

These are framework table stakes with no reference analogue: the
containers are pytrees, so ops must compose with vmap/scan/jit.
"""
import jax
import jax.numpy as jnp
import numpy as np

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import spmv_reference, spmm_reference
from sparsematrix_tpu.utils.testutils import gen_random_dense_sparse


def test_vmap_over_rhs(rng):
    dense = gen_random_dense_sparse(rng, 24, 32, density=0.3)
    A = CSR.fromdense(dense)
    xs = jnp.asarray(rng.uniform(-1, 1, (5, 32)).astype(np.float32))
    ys = np.asarray(jax.vmap(lambda x: spmv_reference(A, x))(xs))
    want = np.asarray(xs) @ dense.T
    np.testing.assert_allclose(ys, want, rtol=1e-5, atol=1e-4)


def test_scan_over_spmv(rng):
    """Power iteration via lax.scan — container closed over, jit outside."""
    dense = gen_random_dense_sparse(rng, 16, 16, density=0.5)
    dense = (dense + dense.T) / 2
    A = CSR.fromdense(dense)
    x0 = jnp.ones(16, jnp.float32)

    @jax.jit
    def power(x0):
        def step(x, _):
            y = spmv_reference(A, x)
            return y / jnp.linalg.norm(y), None

        x, _ = jax.lax.scan(step, x0, None, length=50)
        return x

    v = np.asarray(power(x0))
    lam = v @ dense @ v
    w = np.linalg.eigvalsh(dense)
    assert abs(abs(lam) - np.abs(w).max()) / np.abs(w).max() < 1e-2


def test_bf16_data(rng):
    dense = gen_random_dense_sparse(rng, 32, 40, density=0.25).astype(np.float32)
    A = CSR.fromdense(dense).astype(jnp.bfloat16)
    x = jnp.asarray(rng.uniform(-1, 1, 40).astype(np.float32)).astype(jnp.bfloat16)
    y = np.asarray(spmv_reference(A, x).astype(jnp.float32))
    want = dense @ np.asarray(x.astype(jnp.float32))
    # bf16 has ~3 significant decimal digits
    np.testing.assert_allclose(y, want, rtol=0.05, atol=5.0)


def test_jit_no_retrace_on_new_values(rng):
    """Same structure + new values must hit the jit cache (static aux)."""
    dense = gen_random_dense_sparse(rng, 20, 20, density=0.3)
    A1 = CSR.fromdense(dense)
    A2 = CSR.fromdense(dense * 2.0)
    traces = []

    @jax.jit
    def f(A, x):
        traces.append(1)
        return spmv_reference(A, x)

    x = jnp.ones(20, jnp.float32)
    f(A1, x)
    f(A2, x)
    assert len(traces) == 1, "retraced on value-only change"
