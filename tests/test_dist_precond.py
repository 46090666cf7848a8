"""Distributed block-IC(0)/ILU(0) preconditioning: per-shard triangular solves
inside the dist Krylov solvers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
from jax.sharding import Mesh

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.parallel import (block_ic0_precond,
                                       block_ilu0_precond, dist_bicgstab,
                                       dist_cg, partition_csr_rows,
                                       shard_partitioned)


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("shard",))


def _poisson(side):
    Iq = sps.eye(side)
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (side, side))
    return (sps.kron(Iq, T) + sps.kron(
        sps.diags([-1.0, -1.0], [-1, 1], (side, side)), Iq)).tocsr()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_block_ic0_dist_cg_converges(rng, n_shards):
    sp = _poisson(32)  # n=1024
    n = sp.shape[0]
    A = CSR.from_scipy(sp.astype(np.float32))
    mesh = _mesh(n_shards)
    part = shard_partitioned(partition_csr_rows(A, n_shards), mesh)
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    M = block_ic0_precond(A, n_shards)
    res = dist_cg(part, b, mesh, precond=M, tol=1e-5, maxiter=500)
    x = np.asarray(res.x, np.float64)
    rel = np.linalg.norm(sp @ x - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))
    assert rel < 5e-5, rel
    # the whole point: block-IC(0) beats Jacobi in iterations
    res_j = dist_cg(part, b, mesh, precond="jacobi", tol=1e-5, maxiter=500)
    assert int(res.iters) < int(res_j.iters), (int(res.iters),
                                               int(res_j.iters))


def test_block_ic0_jit_and_reuse(rng):
    sp = _poisson(16)  # n=256
    n = sp.shape[0]
    A = CSR.from_scipy(sp.astype(np.float32))
    mesh = _mesh(4)
    part = shard_partitioned(partition_csr_rows(A, 4), mesh)
    M = block_ic0_precond(A, 4)
    f = jax.jit(lambda bb: dist_cg(part, bb, mesh, precond=M, tol=1e-5,
                                   maxiter=300).x)
    for seed in (0, 1):
        b = jnp.asarray(np.random.default_rng(seed)
                        .standard_normal(n).astype(np.float32))
        x = np.asarray(f(b), np.float64)
        rel = np.linalg.norm(sp @ x - np.asarray(b)) / np.linalg.norm(
            np.asarray(b))
        assert rel < 5e-5, rel


def test_block_ilu0_dist_bicgstab(rng):
    # nonsymmetric: Poisson + skew band
    sp = _poisson(16).tolil()
    n = sp.shape[0]
    for i in range(0, n - 3, 7):
        sp[i, i + 3] += 0.5
    sp = sp.tocsr()
    A = CSR.from_scipy(sp.astype(np.float32))
    mesh = _mesh(4)
    part = shard_partitioned(partition_csr_rows(A, 4), mesh)
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    M = block_ilu0_precond(A, 4)
    res = dist_bicgstab(part, b, mesh, precond=M, tol=1e-5, maxiter=400)
    x = np.asarray(res.x, np.float64)
    rel = np.linalg.norm(sp @ x - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))
    assert rel < 5e-5, rel


def test_block_precond_fixpoint_engine(rng):
    sp = _poisson(16)
    n = sp.shape[0]
    A = CSR.from_scipy(sp.astype(np.float32))
    mesh = _mesh(2)
    part = shard_partitioned(partition_csr_rows(A, 2), mesh)
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    M = block_ic0_precond(A, 2, engine="fixpoint", n_iters=6)
    res = dist_cg(part, b, mesh, precond=M, tol=1e-5, maxiter=400)
    x = np.asarray(res.x, np.float64)
    rel = np.linalg.norm(sp @ x - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))
    assert rel < 5e-5, rel
