"""Randomized property sweeps: many seeds × shapes × densities.

The reference relies on a single unseeded-rand run (SURVEY §4); here the
same properties (roundtrip identity, op-vs-oracle) are swept across a
seed/shape/density grid for stronger coverage.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrix_tpu.formats import CSR, csr_to_bsr, csr_to_blocked_ell
from sparsematrix_tpu.ops import spgemm, spmm_reference, spmv_reference
from sparsematrix_tpu.utils.testutils import gen_random_dense_sparse

GRID = [
    (seed, shape, d)
    for seed in (1, 7, 42)
    for shape, d in [((17, 33), 0.3), ((64, 64), 0.1), ((128, 96), 0.02)]
]


@pytest.mark.parametrize("seed,shape,density", GRID)
def test_roundtrip_and_ops_property(seed, shape, density):
    rng = np.random.default_rng(seed)
    dense = gen_random_dense_sparse(rng, *shape, density=density)
    A = CSR.fromdense(dense)
    # roundtrip exact
    np.testing.assert_array_equal(np.asarray(A.todense()), dense)
    # spmv + spmm vs fp64 oracle
    x = rng.uniform(-1, 1, shape[1]).astype(np.float32)
    X = rng.uniform(-1, 1, (shape[1], 9)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmv_reference(A, jnp.asarray(x))),
        dense.astype(np.float64) @ x, rtol=1e-3, atol=0.5)
    np.testing.assert_allclose(
        np.asarray(spmm_reference(A, jnp.asarray(X))),
        dense.astype(np.float64) @ X, rtol=1e-3, atol=0.5)
    # block formats agree
    for conv in (lambda: csr_to_bsr(A, block_shape=(4, 4)),
                 lambda: csr_to_blocked_ell(A, block_shape=(8, 32))):
        np.testing.assert_array_equal(np.asarray(conv().todense()), dense)


@pytest.mark.parametrize("seed", [3, 11])
def test_spgemm_property(seed):
    rng = np.random.default_rng(seed)
    a = gen_random_dense_sparse(rng, 31, 47, density=0.12)
    b = gen_random_dense_sparse(rng, 47, 23, density=0.12)
    C = spgemm(CSR.fromdense(a), CSR.fromdense(b))
    np.testing.assert_allclose(
        np.asarray(C.todense()),
        a.astype(np.float64) @ b.astype(np.float64), rtol=1e-3, atol=1e-2)


def test_bf16_roundtrip_and_spmv():
    rng = np.random.default_rng(0)
    dense = gen_random_dense_sparse(rng, 40, 40, density=0.2)
    A = CSR.fromdense(dense).astype(jnp.bfloat16)
    back = np.asarray(A.todense().astype(jnp.float32))
    # bf16 quantization error only
    np.testing.assert_allclose(back, dense, rtol=0.01, atol=4.0)


@pytest.mark.parametrize("seed,n,density", [
    (s, n, d) for s in (2, 9) for n, d in [(65, 0.3), (129, 0.08),
                                           (400, 0.02), (1030, 0.01)]
])
def test_trisolve_level_property(seed, n, density):
    """Level-scan solve == scipy triangular solve across seeds/shapes/
    densities (both orientations, including non-multiple-of-128 n)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    from sparsematrix_tpu.ops import trisolve_apply, trisolve_plan

    rng = np.random.default_rng(seed)
    dense = gen_random_dense_sparse(rng, n, n, density=density) / 1000.0
    for lower in (True, False):
        tri = (np.tril(dense, -1) if lower else np.triu(dense, 1))
        tri = tri + np.diag(rng.uniform(1, 2, n).astype(np.float32))
        b = rng.uniform(-1, 1, n).astype(np.float32)
        plan = trisolve_plan(CSR.fromdense(tri), lower=lower)
        x = np.asarray(trisolve_apply(plan, jnp.asarray(b)))
        want = spla.spsolve_triangular(sps.csr_matrix(tri), b, lower=lower)
        np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("seed,shape,density", [
    (s, sh, d) for s in (4, 13) for sh, d in [((130, 1500), 0.05),
                                              ((700, 300), 0.02),
                                              ((2050, 2050), 0.004)]
])
def test_csr_spmv_odd_shapes_property(seed, shape, density):
    """CSR SpMV (gather + segment-sum) == fp64 oracle across odd shapes
    and densities, with the capacity padded past nnz."""
    from sparsematrix_tpu.ops import spmv

    rng = np.random.default_rng(seed)
    dense = gen_random_dense_sparse(rng, *shape, density=density)
    A = CSR.fromdense(dense, capacity=int((dense != 0).sum()) + 77)
    x = rng.uniform(-1, 1, shape[1]).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x)))
    np.testing.assert_allclose(y, dense.astype(np.float64) @ x,
                               rtol=2e-3, atol=0.5)


@pytest.mark.parametrize("seed,n,offsets", [
    (2, 400, (-3, 0, 3)),
    (9, 1030, (-65, -1, 0, 1, 64)),
    (21, 513, tuple(range(-10, 11))),
])
def test_stripdense_property(seed, n, offsets):
    """StripDense spmv/spmm == fp64 oracle across band structures and
    non-multiple-of-128 sizes."""
    import scipy.sparse as sps

    from sparsematrix_tpu.formats import StripDense
    from sparsematrix_tpu.ops import spmm, spmv

    rng = np.random.default_rng(seed)
    mats = [rng.uniform(-10, 10, n - abs(o)).astype(np.float32)
            for o in offsets]
    A = sps.diags(mats, offsets, (n, n)).tocsr().astype(np.float32)
    S = StripDense.from_csr(CSR.from_scipy(A))
    x = rng.uniform(-1, 1, n).astype(np.float32)
    X = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmv(S, jnp.asarray(x))),
        A.astype(np.float64) @ x, rtol=2e-3, atol=0.5)
    np.testing.assert_allclose(
        np.asarray(spmm(S, jnp.asarray(X))),
        A.astype(np.float64) @ X, rtol=2e-3, atol=0.5)


@pytest.mark.parametrize("seed,n,density", [
    (1, 300, 0.03), (7, 1100, 0.01),
])
def test_spgemm_pair_program_property(seed, n, density):
    """Pair-program SpGEMM == scipy across shapes, in both output orders
    (the CSC result exactly matches the pattern of scipy's C^T)."""
    import scipy.sparse as sps

    rs = np.random.RandomState(seed)
    A = sps.random(n, n, density=density, format="csr", random_state=rs,
                   dtype=np.float32)
    B = sps.random(n, n, density=density, format="csr", random_state=rs,
                   dtype=np.float32)
    Ac, Bc = CSR.from_scipy(A), CSR.from_scipy(B)
    want = (A.astype(np.float64) @ B.astype(np.float64)).tocsr()
    for output, ref in (("csr", want), ("csc", want.T.tocsr())):
        ref.sort_indices()
        C = spgemm(Ac, Bc, method="sparse", output=output)
        np.testing.assert_array_equal(np.asarray(C.indptr), ref.indptr)
        np.testing.assert_array_equal(np.asarray(C.indices)[: C.nnz],
                                      ref.indices)
        np.testing.assert_allclose(np.asarray(C.data)[: C.nnz], ref.data,
                                   rtol=2e-4, atol=1e-4)
