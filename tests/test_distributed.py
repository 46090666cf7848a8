"""Distributed SpMV/SpMM on a simulated 8-device CPU mesh.

The reference has no distributed layer; this validates the north-star
capability (1-D row partition with RHS all-gather over the mesh; column
partition with psum reduction) against the single-device oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import spmv, spmm
from sparsematrix_tpu.parallel import (
    dist_spmm,
    dist_spmv,
    make_mesh,
    partition_csr_cols,
    partition_csr_rows,
    shard_partitioned,
)
from sparsematrix_tpu.utils.testutils import (
    gen_matrix_random,
    gen_random_dense_sparse,
)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest should provide 8 virtual devices"
    return make_mesh(8)


@pytest.mark.parametrize("shape", [(64, 64), (250, 130)])
def test_dist_spmv_rows(rng, mesh, shape):
    dense = gen_random_dense_sparse(rng, *shape, density=0.25)
    csr = CSR.fromdense(dense)
    part = shard_partitioned(partition_csr_rows(csr, 8), mesh)
    x = gen_matrix_random(rng, shape[1], 1)[:, 0]
    y = np.asarray(dist_spmv(part, jnp.asarray(x), mesh))
    oracle = np.asarray(spmv(csr, jnp.asarray(x)))
    np.testing.assert_allclose(y, oracle, rtol=1e-4, atol=0.5)


@pytest.mark.parametrize("shape", [(64, 64), (130, 250)])
def test_dist_spmv_cols(rng, mesh, shape):
    dense = gen_random_dense_sparse(rng, *shape, density=0.25)
    csr = CSR.fromdense(dense)
    part = shard_partitioned(partition_csr_cols(csr, 8), mesh)
    x = gen_matrix_random(rng, shape[1], 1)[:, 0]
    y = np.asarray(dist_spmv(part, jnp.asarray(x), mesh))
    oracle = np.asarray(spmv(csr, jnp.asarray(x)))
    np.testing.assert_allclose(y, oracle, rtol=1e-4, atol=0.5)


@pytest.mark.parametrize("k", [8, 33])
def test_dist_spmm_rows(rng, mesh, k):
    shape = (120, 200)
    dense = gen_random_dense_sparse(rng, *shape, density=0.25)
    csr = CSR.fromdense(dense)
    part = shard_partitioned(partition_csr_rows(csr, 8), mesh)
    X = gen_matrix_random(rng, shape[1], k)
    Y = np.asarray(dist_spmm(part, jnp.asarray(X), mesh))
    oracle = np.asarray(spmm(csr, jnp.asarray(X)))
    np.testing.assert_allclose(Y, oracle, rtol=1e-4, atol=0.5)


def test_dist_spgemm(rng, mesh):
    from sparsematrix_tpu.parallel import (
        dist_spgemm_apply,
        dist_spgemm_plan,
        shard_dist_spgemm,
    )

    a = gen_random_dense_sparse(rng, 40, 64, density=0.15)
    b = gen_random_dense_sparse(rng, 64, 36, density=0.15)
    plan = shard_dist_spgemm(
        dist_spgemm_plan(CSR.fromdense(a), CSR.fromdense(b), 8), mesh
    )
    C = dist_spgemm_apply(plan, mesh)
    oracle = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(np.asarray(C.todense()), oracle,
                               rtol=1e-4, atol=1.0)


def test_dist_spmv_jit_compiles(rng, mesh):
    """The whole distributed op must be jittable end-to-end."""
    dense = gen_random_dense_sparse(rng, 64, 64, density=0.3)
    csr = CSR.fromdense(dense)
    part = shard_partitioned(partition_csr_rows(csr, 8), mesh)
    x = jnp.asarray(gen_matrix_random(rng, 64, 1)[:, 0])

    f = jax.jit(lambda p, v: dist_spmv(p, v, mesh))
    y1 = np.asarray(f(part, x))
    y2 = np.asarray(f(part, 2 * x))
    np.testing.assert_allclose(y2, 2 * y1, rtol=1e-5, atol=1e-3)


def test_dist_spmm_bell(rng, mesh):
    from sparsematrix_tpu.formats import csr_to_blocked_ell
    from sparsematrix_tpu.parallel import (
        dist_spmm_bell,
        partition_bell_rows,
        shard_bell,
    )

    dense = gen_random_dense_sparse(rng, 128, 256, density=0.05)
    bell = csr_to_blocked_ell(CSR.fromdense(dense), block_shape=(8, 64))
    part = shard_bell(partition_bell_rows(bell, 8), mesh)
    X = gen_matrix_random(rng, 256, 32)
    Y = np.asarray(dist_spmm_bell(part, jnp.asarray(X), mesh))
    oracle = dense.astype(np.float64) @ X
    np.testing.assert_allclose(Y, oracle, rtol=1e-4, atol=0.5)


def test_dist_spmv_halo_banded(rng, mesh):
    from sparsematrix_tpu.parallel import (
        dist_spmv_halo,
        partition_csr_halo,
        shard_halo,
    )

    n = 256
    bw = 9
    dense = np.zeros((n, n), dtype=np.float32)
    for off in range(-bw // 2, bw // 2 + 1):
        i = np.arange(max(0, -off), min(n, n - off))
        dense[i, i + off] = rng.uniform(-1, 1, i.shape[0])
    csr = CSR.fromdense(dense)
    part = shard_halo(partition_csr_halo(csr, 8, halo=8), mesh)
    x = gen_matrix_random(rng, n, 1)[:, 0]
    y = np.asarray(dist_spmv_halo(part, jnp.asarray(x), mesh))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=0.5)


def test_halo_partition_rejects_nonlocal(rng):
    from sparsematrix_tpu.parallel import partition_csr_halo

    dense = gen_random_dense_sparse(rng, 64, 64, density=0.3)  # global coupling
    with pytest.raises(ValueError):
        partition_csr_halo(CSR.fromdense(dense), 8, halo=2)


def test_dist_spmm_2d(rng):
    from sparsematrix_tpu.parallel import dist_spmm_2d, make_mesh_2d

    mesh2 = make_mesh_2d(4, 2)
    dense = gen_random_dense_sparse(rng, 96, 120, density=0.2)
    csr = CSR.fromdense(dense)
    part = partition_csr_rows(csr, 4)
    from jax.sharding import NamedSharding, PartitionSpec as P

    part = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh2, P("row"))), part
    )
    X = gen_matrix_random(rng, 120, 10)
    Y = np.asarray(dist_spmm_2d(part, jnp.asarray(X), mesh2))
    oracle = np.asarray(spmm(csr, jnp.asarray(X)))
    np.testing.assert_allclose(Y, oracle, rtol=1e-4, atol=0.5)


def test_global_mesh_helper():
    from sparsematrix_tpu.parallel.multihost import global_mesh

    m1 = global_mesh()
    assert m1.devices.size == jax.device_count()
    m2 = global_mesh(("row", "col"), shape=(4, 2))
    assert m2.shape == {"row": 4, "col": 2}


# ---------------------------------------------------------------------------
# Round-2 additions: psum_scatter variants, column-partitioned SpMM,
# variable halos, scaling accounting
# ---------------------------------------------------------------------------


def test_dist_spmv_cols_psum_scatter(rng, mesh):
    from sparsematrix_tpu.parallel import (
        dist_spmv, partition_csr_cols, shard_partitioned,
    )

    dense = gen_random_dense_sparse(rng, 100, 96, density=0.2)
    part = shard_partitioned(
        partition_csr_cols(CSR.fromdense(dense), 8), mesh)
    x = jnp.asarray(rng.standard_normal(96).astype(np.float32))
    got = np.asarray(dist_spmv(part, x, mesh, reduce="psum_scatter"))
    np.testing.assert_allclose(got, dense.astype(np.float64) @ np.asarray(x),
                               rtol=2e-3, atol=0.5)


def test_dist_spmm_cols_both_reduces(rng, mesh):
    from sparsematrix_tpu.parallel import (
        dist_spmm, partition_csr_cols, shard_partitioned,
    )

    dense = gen_random_dense_sparse(rng, 64, 80, density=0.15)
    part = shard_partitioned(
        partition_csr_cols(CSR.fromdense(dense), 8), mesh)
    X = jnp.asarray(rng.standard_normal((80, 16)).astype(np.float32))
    want = dense.astype(np.float64) @ np.asarray(X)
    for reduce in ("psum", "psum_scatter"):
        got = np.asarray(dist_spmm(part, X, mesh, reduce=reduce))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.5,
                                   err_msg=reduce)


def test_var_halo_spmv(rng, mesh):
    from sparsematrix_tpu.parallel import (
        dist_spmv_halo_var, partition_csr_halo_var,
    )
    from sparsematrix_tpu.parallel.halo import VarHaloPartitionedCSR

    # banded matrix with varying bandwidth per region
    n = 128
    dense = np.zeros((n, n), np.float32)
    for i in range(n):
        w = 3 if i < 64 else 9  # wider band in the lower half
        for j in range(max(0, i - w), min(n, i + w + 1)):
            dense[i, j] = rng.standard_normal()
    part = partition_csr_halo_var(CSR.fromdense(dense), 8)
    assert isinstance(part, VarHaloPartitionedCSR)
    # per-shard halos vary and ragged bytes < padded bytes
    assert part.ragged_bytes < part.padded_bytes
    sharded = jax.tree_util.tree_map(
        lambda a: jax.device_put(
            a, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("shard"))), part)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    got = np.asarray(dist_spmv_halo_var(sharded, x, mesh))
    np.testing.assert_allclose(got, dense.astype(np.float64) @ np.asarray(x),
                               rtol=2e-3, atol=0.5)


def test_var_halo_rejects_nonlocal(rng):
    from sparsematrix_tpu.parallel import partition_csr_halo_var

    dense = np.zeros((64, 64), np.float32)
    dense[0, 63] = 1.0  # reaches across the whole matrix
    import pytest

    with pytest.raises(ValueError):
        partition_csr_halo_var(CSR.fromdense(dense), 8)


def test_scaling_accounting_matches_partition(rng):
    """The cost formulas must agree with the actual partition geometry."""
    from sparsematrix_tpu.parallel import (
        halo_cost, partition_csr_halo_var, spmv_row_cost, weak_scaling_table,
    )

    n, nshards = 256, 8
    dense = gen_random_dense_sparse(rng, n, n, density=0.1)
    c = spmv_row_cost(n, n, int((dense != 0).sum()), nshards)
    # all_gather of x: each device receives the other shards' bands
    band = -(-n // nshards)
    assert c.comm_bytes_per_device == (nshards - 1) * band * 4

    # halo accounting vs the real partition
    bd = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(max(0, i - 2), min(n, i + 3)):
            bd[i, j] = 1.0
    part = partition_csr_halo_var(CSR.fromdense(bd), nshards)
    hc = halo_cost(part)
    assert hc.comm_bytes_per_device == part.ragged_bytes // nshards
    # interior shards need 2-wide halos both sides; 14 links x 2 x 4B
    assert part.ragged_bytes == int(np.asarray(part.h_l).sum()
                                    + np.asarray(part.h_r).sum()) * 4

    table = weak_scaling_table(4096, 64, ns=[1, 2, 4, 8])
    assert len(table) == 4
    assert table[0]["weak_scaling_efficiency"] == 1.0
    assert all(0 < row["weak_scaling_efficiency"] <= 1.0 for row in table)


def test_var_halo_ragged_branch_cpu_limitation(rng, mesh):
    """The ragged_all_to_all branch (halo.py dist_spmv_halo_var
    use_ragged=True) cannot execute on XLA:CPU — pin the documented
    limitation so we notice the day the backend gains the kernel.

    The branch itself runs on the GPU in ``chip_smoke.py --four``.
    """
    from sparsematrix_tpu.parallel import (
        dist_spmv_halo_var, partition_csr_halo_var,
    )

    n = 128
    dense = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(max(0, i - 3), min(n, i + 4)):
            dense[i, j] = rng.standard_normal()
    part = partition_csr_halo_var(CSR.fromdense(dense), 8)
    sharded = jax.tree_util.tree_map(
        lambda a: jax.device_put(
            a, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("shard"))), part)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    import pytest

    try:
        got = dist_spmv_halo_var(sharded, x, mesh, use_ragged=True)
        got = np.asarray(got)
    except Exception as e:  # noqa: BLE001 — backend raises JaxRuntimeError
        assert "ragged-all-to-all" in str(e) or "UNIMPLEMENTED" in str(e), e
        return
    # If XLA:CPU gained the kernel, the result must be correct — and the
    # platform rule in config.ragged_halo() should be widened to the CPU.
    np.testing.assert_allclose(got, dense.astype(np.float64) @ np.asarray(x),
                               rtol=2e-3, atol=0.5)
    pytest.fail("XLA:CPU now supports ragged_all_to_all — update "
                "config.ragged_halo() and this test")
