"""Planned permutations (ops/permute.py).

The sort path must be bit-identical to the gather path — it is the same
map, executed through ``lax.sort_key_val``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops.permute import (apply_permutation,
                                          plan_gather_permutation)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("force_sort", [True, False])
def test_pure_permutation(rng, force_sort):
    n = 1000
    g = rng.permutation(n)
    x = rng.standard_normal(n).astype(np.float32)
    plan = plan_gather_permutation(g, n, force_sort=force_sort)
    out = np.asarray(apply_permutation(plan, jnp.asarray(x)))
    np.testing.assert_array_equal(out, x[g])


@pytest.mark.parametrize("force_sort", [True, False])
def test_sentinels_and_expansion(rng, force_sort):
    # n_out > n_src with sentinel slots sprinkled in
    n_src, n_out = 500, 800
    g = np.full(n_out, n_src + 7)
    sel = rng.choice(n_out, 400, replace=False)
    g[sel] = rng.choice(n_src, 400, replace=False)
    x = rng.standard_normal(n_src).astype(np.float32)
    want = np.where(g < n_src, x[np.minimum(g, n_src - 1)], 0)
    plan = plan_gather_permutation(g, n_src, force_sort=force_sort)
    out = np.asarray(apply_permutation(plan, jnp.asarray(x)))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("force_sort", [True, False])
def test_truncating_injection(rng, force_sort):
    n_src, n_out = 900, 300
    g = rng.choice(n_src, n_out, replace=False)
    x = rng.standard_normal(n_src).astype(np.float32)
    plan = plan_gather_permutation(g, n_src, force_sort=force_sort)
    out = np.asarray(apply_permutation(plan, jnp.asarray(x)))
    np.testing.assert_array_equal(out, x[g])


def test_non_injective_rejected():
    with pytest.raises(ValueError):
        plan_gather_permutation(np.array([0, 1, 1]), 3)


def test_jit_and_grad(rng):
    n = 256
    g = rng.permutation(n)
    plan = plan_gather_permutation(g, n, force_sort=True)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    f = jax.jit(lambda x: apply_permutation(plan, x).sum())
    gx = jax.grad(f)(x)
    # d(sum of permuted)/dx = ones
    np.testing.assert_allclose(np.asarray(gx), 1.0)


@pytest.mark.parametrize("output", ["csr", "csc"])
def test_spgemm_sort_vs_gather_paths(rng, output):
    """The CSR↔CSC reorder of an SpGEMM result as a planned permutation:
    the sort plan must match the gather plan bit-for-bit, and both must
    match the fp64 oracle in the target order."""
    import scipy.sparse as sps

    from sparsematrix_tpu.ops import spgemm

    n = 512
    sa = sps.random(n, n, density=0.02, random_state=3, format="csr",
                    dtype=np.float32)
    sb = sps.random(n, n, density=0.02, random_state=4, format="csr",
                    dtype=np.float32)
    sa.data = rng.uniform(-10, 10, sa.nnz).astype(np.float32)
    sb.data = rng.uniform(-10, 10, sb.nnz).astype(np.float32)
    A, B = CSR.from_scipy(sa), CSR.from_scipy(sb)
    # source order is the other output order; g maps target slots to it
    src = spgemm(A, B, output="csc" if output == "csr" else "csr")
    nnz = src.nnz
    rows = np.asarray(src.row_ids)[:nnz]
    cols = np.asarray(src.indices)[:nnz]
    # target order: sort the source slots by the target's (row, col) key
    g = np.lexsort((rows, cols))  # source is the transpose of the target
    pp_s = plan_gather_permutation(g, nnz, force_sort=True)
    pp_g = plan_gather_permutation(g, nnz, force_sort=False)
    assert pp_s.use_sort and not pp_g.use_sort
    got_s = np.asarray(apply_permutation(pp_s, src.data))
    got_g = np.asarray(apply_permutation(pp_g, src.data))
    np.testing.assert_array_equal(got_s, got_g)
    want = (sa.astype(np.float64) @ sb.astype(np.float64))
    want = (want.T.tocsr() if output == "csc" else want.tocsr())
    want.sort_indices()
    np.testing.assert_allclose(got_s, want.data, rtol=2e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# row-wise (2-D) apply — each moved row is one contiguous k-element run


@pytest.mark.parametrize("force_sort", [True, False])
def test_rows_pure_permutation(rng, force_sort):
    n, k = 1000, 7
    g = rng.permutation(n)
    x = rng.standard_normal((n, k)).astype(np.float32)
    plan = plan_gather_permutation(g, n, force_sort=force_sort)
    out = np.asarray(apply_permutation(plan, jnp.asarray(x)))
    np.testing.assert_array_equal(out, x[g])
    # 1-D column-by-column agreement (same plan object serves both)
    for j in range(k):
        col = np.asarray(apply_permutation(plan, jnp.asarray(x[:, j])))
        np.testing.assert_array_equal(out[:, j], col)


@pytest.mark.parametrize("force_sort", [True, False])
def test_rows_sentinels_and_expansion(rng, force_sort):
    # n_out > n_src with sentinel slots reading zero rows
    n_src, n_out, k = 600, 900, 5
    g = np.full(n_out, n_src + 17, np.int64)
    live = rng.choice(n_out, size=n_src, replace=False)
    g[live] = rng.permutation(n_src)
    x = rng.standard_normal((n_src, k)).astype(np.float32)
    plan = plan_gather_permutation(g, n_src, force_sort=force_sort)
    out = np.asarray(apply_permutation(plan, jnp.asarray(x)))
    want = np.zeros((n_out, k), np.float32)
    want[live] = x[g[live]]
    np.testing.assert_array_equal(out, want)


def test_rows_dropped_sources(rng):
    # injective but non-surjective: some sources are dropped (n_out < n_src)
    n_src, n_out, k = 800, 500, 3
    g = rng.choice(n_src, size=n_out, replace=False)
    x = rng.standard_normal((n_src, k)).astype(np.float32)
    for force_sort in (True, False):
        plan = plan_gather_permutation(g, n_src, force_sort=force_sort)
        out = np.asarray(apply_permutation(plan, jnp.asarray(x)))
        np.testing.assert_array_equal(out, x[g])


def test_rows_auto_tier_picks_sort(rng):
    """At SORT_MIN_ELEMS the default plan is the sort form; rows apply
    through its keys, with sentinels and dropped sources."""
    from sparsematrix_tpu.ops.permute import SORT_MIN_ELEMS

    n, k = SORT_MIN_ELEMS, 6
    g = rng.permutation(n)
    plan = plan_gather_permutation(g, n)
    assert plan.use_sort
    x = rng.standard_normal((n, k)).astype(np.float32)
    out = np.asarray(apply_permutation(plan, jnp.asarray(x)))
    np.testing.assert_array_equal(out, x[g])
    g2 = np.full(n, n + 5, np.int64)
    live = rng.choice(n, size=n // 2, replace=False)
    g2[live] = rng.choice(n, size=n // 2, replace=False)
    plan2 = plan_gather_permutation(g2, n)
    assert plan2.use_sort
    out2 = np.asarray(apply_permutation(plan2, jnp.asarray(x)))
    want = np.zeros((n, k), np.float32)
    want[live] = x[g2[live]]
    np.testing.assert_array_equal(out2, want)
