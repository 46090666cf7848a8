"""Ring-pipelined halo SpMV: 2/4/8-device numerics and the structural
overlap property (the owned-block partial product must not depend on the
ppermute outputs, so XLA can run the exchange concurrently)."""
import jax
import jax.extend  # noqa: F401 — jax.extend.core.Literal below
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.parallel import (dist_spmv_halo_ring,
                                       partition_csr_halo_ring,
                                       shard_halo_ring)


def _banded(rng, n, bw):
    dense = np.zeros((n, n), np.float32)
    for off in range(-bw, bw + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        dense[idx, idx + off] = rng.uniform(-1000, 1000, idx.shape[0])
    return dense


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("shard",))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_halo_ring_matches_dense(rng, n_shards):
    n = 512
    dense = _banded(rng, n, 24)
    A = CSR.fromdense(dense)
    part = shard_halo_ring(partition_csr_halo_ring(A, n_shards, halo=32),
                           _mesh(n_shards))
    x = rng.standard_normal(n).astype(np.float32)
    y = dist_spmv_halo_ring(part, jnp.asarray(x), _mesh(n_shards))
    np.testing.assert_allclose(np.asarray(y), dense.astype(np.float64) @ x,
                               rtol=2e-3, atol=0.5)


def test_halo_ring_split_is_exhaustive(rng):
    """Every nnz lands in exactly one of the owned/halo blocks."""
    n = 256
    dense = _banded(rng, n, 10)
    A = CSR.fromdense(dense)
    part = partition_csr_halo_ring(A, 4, halo=16)
    stored = (int((np.asarray(part.own_data) != 0).sum())
              + int((np.asarray(part.halo_data) != 0).sum()))
    assert stored == A.nnz


def test_halo_ring_rejects_nonlocal(rng):
    n = 256
    dense = np.zeros((n, n), np.float32)
    dense[0, n - 1] = 1.0  # corner entry: reaches across the ring
    dense[np.arange(n), np.arange(n)] = 1.0
    with pytest.raises(ValueError, match="exceed halo window"):
        partition_csr_halo_ring(CSR.fromdense(dense), 4, halo=8)


def _descendants(jaxpr, seed_vars):
    """All vars reachable from seed_vars through the eqn graph."""
    seen = {str(v) for v in seed_vars}
    changed = True
    while changed:
        changed = False
        for eqn in jaxpr.eqns:
            if any(str(v) in seen for v in eqn.invars
                   if not isinstance(v, jax.extend.core.Literal)):
                for ov in eqn.outvars:
                    if str(ov) not in seen:
                        seen.add(str(ov))
                        changed = True
    return seen


def test_halo_ring_owned_compute_is_overlappable(rng):
    """Structural: the ppermute outputs and the owned partial matvec live
    in the same computation with NO dependency path between them, so the
    scheduler is free to overlap the collective with the owned compute."""
    n = 256
    n_shards = 4
    dense = _banded(rng, n, 10)
    A = CSR.fromdense(dense)
    mesh = _mesh(n_shards)
    part = shard_halo_ring(partition_csr_halo_ring(A, n_shards, halo=16),
                           mesh)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    jaxpr = jax.make_jaxpr(
        lambda p, v: dist_spmv_halo_ring(p, v, mesh))(part, x)

    # locate the shard_map inner jaxpr
    def find_inner(jx):
        for eqn in jx.eqns:
            if "shard_map" in str(eqn.primitive):
                return eqn.params["jaxpr"]
            for sub in jax.core.subjaxprs(jx):
                got = find_inner(sub)
                if got is not None:
                    return got
        return None

    inner = find_inner(jaxpr.jaxpr)
    assert inner is not None, "no shard_map region found"
    perm_outs = []
    scatter_adds = []  # segment_sum lowers to scatter-add
    for eqn in inner.eqns:
        if "ppermute" in str(eqn.primitive):
            perm_outs.extend(eqn.outvars)
        if "scatter-add" in str(eqn.primitive) or "scatter_add" in str(
                eqn.primitive):
            scatter_adds.append(eqn)
    assert perm_outs, "no ppermute in the shard_map region"
    assert len(scatter_adds) >= 2, "expected owned + halo segment sums"
    desc = _descendants(inner, perm_outs)
    # at least one segment_sum must be independent of both ppermutes —
    # that is the owned-block partial the scheduler can overlap
    indep = [
        e for e in scatter_adds
        if not any(str(v) in desc for v in e.invars
                   if not isinstance(v, jax.extend.core.Literal))
    ]
    assert indep, ("every segment_sum depends on the ppermute outputs — "
                   "the owned block is not overlappable")
