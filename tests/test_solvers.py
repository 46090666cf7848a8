"""Krylov solvers: CG (SPD), BiCGSTAB (general), ILU-preconditioned."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import ilu0_plans, ilu_apply
from sparsematrix_tpu.solvers import bicgstab, cg


def _spd(rng, n, density=0.1):
    m = (rng.random((n, n)) < density) * rng.uniform(-1, 1, (n, n))
    m = (m + m.T) / 2
    m = m.astype(np.float32)
    np.fill_diagonal(m, np.abs(m).sum(axis=1) + 1.0)
    return m


def _nonsym(rng, n, density=0.1):
    m = ((rng.random((n, n)) < density) * rng.uniform(-1, 1, (n, n))).astype(
        np.float32
    )
    np.fill_diagonal(m, np.abs(m).sum(axis=1) + 1.0)
    return m


@pytest.mark.parametrize("n", [32, 128])
def test_cg_spd(rng, n):
    a = _spd(rng, n)
    A = CSR.fromdense(a)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    res = cg(A, jnp.asarray(b), tol=1e-6, maxiter=500)
    x = np.asarray(res.x)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-4
    assert int(res.iters) < 500


@pytest.mark.parametrize("n", [32, 100])
def test_bicgstab_nonsymmetric(rng, n):
    a = _nonsym(rng, n)
    A = CSR.fromdense(a)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    res = bicgstab(A, jnp.asarray(b), tol=1e-6, maxiter=500)
    x = np.asarray(res.x)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-4


def test_cg_ilu_preconditioned_converges_faster(rng):
    n = 120
    a = _spd(rng, n, density=0.08)
    A = CSR.fromdense(a)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    plans = ilu0_plans(A)
    plain = cg(A, jnp.asarray(b), tol=1e-8, maxiter=1000)
    pre = cg(A, jnp.asarray(b), tol=1e-8, maxiter=1000,
             M=functools.partial(ilu_apply, plans))
    assert int(pre.iters) <= int(plain.iters)
    x = np.asarray(pre.x)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-5


def test_cg_jittable(rng):
    n = 40
    a = _spd(rng, n)
    A = CSR.fromdense(a)
    b = jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32))
    f = jax.jit(lambda A, b: cg(A, b, tol=1e-6, maxiter=200).x)
    x = np.asarray(f(A, b))
    assert np.linalg.norm(a @ x - np.asarray(b)) < 1e-3


def test_cg_matvec_callable(rng):
    n = 24
    a = _spd(rng, n)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    res = cg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=1e-6,
             maxiter=200)
    assert np.linalg.norm(a @ np.asarray(res.x) - b) < 1e-3


def test_cg_with_packed_spmv(rng):
    """Solvers compose with the prepared SpMV layouts (strip pack)."""
    from sparsematrix_tpu.ops import prepare_spmv

    n = 64
    a = _spd(rng, n, density=0.2)
    packed = prepare_spmv(CSR.fromdense(a), layout="strip")
    b = rng.uniform(-1, 1, n).astype(np.float32)
    res = cg(packed, jnp.asarray(b), tol=1e-6, maxiter=300)
    x = np.asarray(res.x)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-4
