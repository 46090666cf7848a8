"""SpGEMM vs scipy oracle; plan reuse across value changes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import spgemm, spgemm_apply, spgemm_plan
from sparsematrix_tpu.utils.testutils import gen_random_dense_sparse


@pytest.mark.parametrize("shapes", [((20, 30), (30, 25)), ((64, 64), (64, 64))])
@pytest.mark.parametrize("density", [0.05, 0.2])
def test_spgemm_vs_scipy(rng, shapes, density):
    (m, k), (k2, n) = shapes
    a = gen_random_dense_sparse(rng, m, k, density=density)
    b = gen_random_dense_sparse(rng, k2, n, density=density)
    A, B = CSR.fromdense(a), CSR.fromdense(b)
    C = spgemm(A, B)
    oracle = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(np.asarray(C.todense()), oracle,
                               rtol=1e-4, atol=1e-3)


def test_spgemm_plan_reuse_jit(rng):
    """Numeric phase is jittable and reusable for new values on the same
    pattern (encode-once / multiply-many)."""
    a = gen_random_dense_sparse(rng, 32, 40, density=0.15)
    b = gen_random_dense_sparse(rng, 40, 24, density=0.15)
    A, B = CSR.fromdense(a), CSR.fromdense(b)
    plan = spgemm_plan(A, B)
    f = jax.jit(lambda p, da, db: spgemm_apply(p, da, db).data)

    d1 = np.asarray(f(plan, A.data, B.data))
    # same pattern, new values
    A2 = CSR.fromdense(a * 3.0)
    d2 = np.asarray(f(plan, A2.data, B.data))
    np.testing.assert_allclose(d2, 3.0 * d1, rtol=1e-5, atol=1e-4)


def test_spgemm_empty_product(rng):
    a = np.zeros((8, 8), np.float32)
    a[0, 1] = 2.0
    b = np.zeros((8, 8), np.float32)
    b[2, 3] = 5.0  # no k-match with a
    C = spgemm(CSR.fromdense(a), CSR.fromdense(b))
    np.testing.assert_array_equal(np.asarray(C.todense()), np.zeros((8, 8)))


def test_spgemm_shape_mismatch(rng):
    A = CSR.fromdense(np.eye(4, dtype=np.float32))
    B = CSR.fromdense(np.eye(5, dtype=np.float32))
    with pytest.raises(ValueError):
        spgemm(A, B)


def test_spgemm_densify_matches_scipy(rng):
    import scipy.sparse as sps

    from sparsematrix_tpu.formats import Dense
    from sparsematrix_tpu.ops import spgemm_densify, spgemm_extract

    A = sps.random(200, 300, density=0.05, random_state=3, format="csr",
                   dtype=np.float32)
    B = sps.random(300, 250, density=0.05, random_state=4, format="csr",
                   dtype=np.float32)
    Ac, Bc = CSR.from_scipy(A), CSR.from_scipy(B)
    want = np.asarray((A.astype(np.float64) @ B.astype(np.float64)).todense())
    D = spgemm_densify(Ac, Bc)
    assert isinstance(D, Dense)
    np.testing.assert_allclose(np.asarray(D.data), want, rtol=1e-4, atol=1e-3)
    # pattern extraction equals the pair-program numeric phase
    plan = spgemm_plan(Ac, Bc)
    C = spgemm_extract(plan, D)
    ref = spgemm_apply(plan, Ac.data, Bc.data)
    np.testing.assert_allclose(
        np.asarray(C.data)[: plan.c_nnz],
        np.asarray(ref.data)[: plan.c_nnz], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(C.todense()), want,
                               rtol=1e-4, atol=1e-3)


def test_spgemm_densify_jittable(rng):
    import scipy.sparse as sps

    from sparsematrix_tpu.ops import spgemm_densify

    A = sps.random(64, 64, density=0.1, random_state=5, format="csr",
                   dtype=np.float32)
    Ac = CSR.from_scipy(A)
    f = jax.jit(lambda a, b: spgemm_densify(a, b).data)
    got = np.asarray(f(Ac, Ac))
    want = np.asarray((A.astype(np.float64) @ A.astype(np.float64)).todense())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_spgemm_method_auto_routes(rng):
    """method='auto' must pick densify at small-dense shapes and stay
    correct under both forced methods."""
    import scipy.sparse as sps
    from sparsematrix_tpu.ops.spgemm import spgemm

    a = sps.random(256, 256, 0.05, random_state=3, format="csr",
                   dtype=np.float32)
    b = sps.random(256, 256, 0.05, random_state=4, format="csr",
                   dtype=np.float32)
    A, B = CSR.from_scipy(a), CSR.from_scipy(b)
    want = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    want.sort_indices()
    for method in ("auto", "sparse", "densify"):
        C = spgemm(A, B, method=method)
        got = np.asarray(C.to_scipy().todense())
        np.testing.assert_allclose(got, want.todense(), rtol=2e-3, atol=0.5)


def test_spgemm_auto_picks_sparse_at_scale():
    """The routing model must choose the pair program at the XL regime."""
    import importlib

    sg = importlib.import_module("sparsematrix_tpu.ops.spgemm")

    # n=16384, d=0.001-equivalent pair count: dense time >> sparse time
    m = k = n = 16384
    pairs = 4_400_000
    t_dense = 2.0 * m * k * n / sg._DENSE_FLOPS_PER_S
    t_sparse = pairs / sg._PAIRS_PER_S
    assert t_sparse < t_dense


def test_spgemm_output_csc_dispatch(rng):
    """spgemm(output='csc') returns C^T as CSR (CopyTo(trans) analogue),
    planned as Bᵀ @ Aᵀ on the pair program."""
    import scipy.sparse as sps

    from sparsematrix_tpu.ops.spgemm import spgemm

    n = 256
    sa = sps.random(n, n, density=0.03, random_state=3, format="csr",
                    dtype=np.float32)
    sb = sps.random(n, n, density=0.03, random_state=4, format="csr",
                    dtype=np.float32)
    sa.data = rng.uniform(-10, 10, sa.nnz).astype(np.float32)
    sb.data = rng.uniform(-10, 10, sb.nnz).astype(np.float32)
    A, B = CSR.from_scipy(sa), CSR.from_scipy(sb)
    Ct = spgemm(A, B, output="csc")
    want = (sa.astype(np.float64) @ sb.astype(np.float64)).T.tocsr()
    assert Ct.shape == (n, n)
    np.testing.assert_allclose(np.asarray(Ct.todense()),
                               want.todense(), rtol=2e-3, atol=0.5)
    # every method honours the CSC output
    for method in ("sparse", "densify"):
        Cm = spgemm(A, B, method=method, output="csc")
        np.testing.assert_allclose(np.asarray(Cm.todense()),
                                   want.todense(), rtol=2e-3, atol=0.5)
    import pytest

    with pytest.raises(ValueError):
        spgemm(A, B, output="weird")


def test_spgemm_apply_reuses_plan_for_new_values(rng):
    """The numeric phase multiplies any values on the planned patterns."""
    da = gen_random_dense_sparse(rng, 60, 80, density=0.1)
    db = gen_random_dense_sparse(rng, 80, 70, density=0.1)
    A, B = CSR.fromdense(da), CSR.fromdense(db)
    plan = spgemm_plan(A, B)
    db2 = np.where(db != 0, db * 2.0 + 1.0, 0).astype(np.float32)
    C2 = spgemm_apply(plan, A.data, CSR.fromdense(db2).data)
    want2 = da.astype(np.float64) @ db2.astype(np.float64)
    np.testing.assert_allclose(np.asarray(C2.todense()), want2,
                               rtol=2e-3, atol=0.5)


def test_spgemm_apply_grad_bdata(rng):
    """d/db_data through gather → multiply → segment_sum, against central
    finite differences (the phase is linear in b_data, so they are exact
    up to rounding)."""
    da = gen_random_dense_sparse(rng, 40, 48, density=0.1)
    db = gen_random_dense_sparse(rng, 48, 36, density=0.1)
    A, B = CSR.fromdense(da), CSR.fromdense(db)
    plan = spgemm_plan(A, B)
    w = np.random.default_rng(0).standard_normal(
        int(plan.c_indices.shape[0])).astype(np.float32)

    def loss(bd):
        return jnp.vdot(jnp.asarray(w), spgemm_apply(plan, A.data, bd).data)

    g = np.asarray(jax.grad(loss)(B.data))
    bd = np.asarray(B.data)
    for i in (0, len(bd) // 2, len(bd) - 1):
        e = np.zeros_like(bd)
        e[i] = 1.0
        h = 0.5
        fd = (loss(jnp.asarray(bd + h * e))
              - loss(jnp.asarray(bd - h * e))) / (2 * h)
        np.testing.assert_allclose(g[i], float(fd), rtol=2e-2, atol=1e-3)


def test_spgemm_apply_grad_adata_linear(rng):
    """The numeric phase is LINEAR in a_data: the directional derivative
    along v equals the loss evaluated at v."""
    n = 96
    A = CSR.fromdense(gen_random_dense_sparse(rng, n, n, density=0.08))
    B = CSR.fromdense(gen_random_dense_sparse(rng, n, n, density=0.08))
    plan = spgemm_plan(A, B)
    w = jnp.asarray(np.random.default_rng(1).standard_normal(
        plan.c_indices.shape[0]).astype(np.float32))

    def loss(ad):
        return jnp.vdot(w, spgemm_apply(plan, ad, B.data).data)

    g = jax.grad(loss)(jnp.asarray(A.data))
    v = np.random.default_rng(2).standard_normal(A.data.shape[0]).astype(
        np.float32)
    np.testing.assert_allclose(float(np.dot(np.asarray(g), v)),
                               float(loss(jnp.asarray(v))),
                               rtol=2e-3, atol=1e-3)
