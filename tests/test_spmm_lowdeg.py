"""Sliced-ELL row-gather SpMM (ops/spmm_lowdeg.py): packing, routing of a
pack through ``spmm``, oracle, autodiff."""
import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops.spmm import spmm
from sparsematrix_tpu.ops.spmm_lowdeg import (SlicedEllMM, pack_sliced_ell,
                                              spmm_sliced_ell)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("deg", [1, 3, 9])
def test_sliced_ell_oracle(rng, deg):
    n, m, k = 3000, 2500, 13
    sp = sps.random(n, m, density=deg / m, random_state=2, format="csr",
                    dtype=np.float32)
    sp.data = rng.uniform(-10, 10, sp.nnz).astype(np.float32)
    pk = pack_sliced_ell(CSR.from_scipy(sp))
    assert pk.fill_rate > 0.5  # segments bound the width padding
    X = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    got = np.asarray(jax.jit(spmm_sliced_ell)(pk, jnp.asarray(X)))
    want = sp.astype(np.float64) @ X
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.5)


def test_sliced_ell_auto_route(rng):
    n = 8192
    sp = sps.random(n, n, density=2.0 / n, random_state=3, format="csr",
                    dtype=np.float32)
    sp.data = rng.uniform(-5, 5, sp.nnz).astype(np.float32)
    A = CSR.from_scipy(sp)
    X = jnp.asarray(rng.uniform(-1, 1, (n, 8)).astype(np.float32))
    pk = pack_sliced_ell(A)
    assert isinstance(pk, SlicedEllMM)
    got = np.asarray(spmm(pk, X))  # a pack routes to the sliced-ELL product
    want = sp.astype(np.float64) @ np.asarray(X, np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.5)
    # the CSR's own auto route agrees
    np.testing.assert_allclose(np.asarray(spmm(A, X)), got, rtol=1e-5,
                               atol=1e-4)


def test_sliced_ell_grad(rng):
    n, k = 1500, 5
    sp = sps.random(n, n, density=3.0 / n, random_state=4, format="csr",
                    dtype=np.float32)
    sp.data = rng.uniform(-2, 2, sp.nnz).astype(np.float32)
    pk = pack_sliced_ell(CSR.from_scipy(sp))
    X = jnp.asarray(rng.uniform(-1, 1, (n, k)).astype(np.float32))
    W = jnp.asarray(rng.uniform(-1, 1, (n, k)).astype(np.float32))
    gX = jax.grad(lambda xx: (spmm_sliced_ell(pk, xx) * W).sum())(X)
    want = sp.T.astype(np.float64) @ np.asarray(W)
    np.testing.assert_allclose(np.asarray(gX), want, rtol=2e-3, atol=0.5)


def test_sliced_ell_empty_rows(rng):
    # rows with zero entries + an empty matrix corner
    sp = sps.csr_matrix((64, 64), dtype=np.float32)
    pk = pack_sliced_ell(CSR.from_scipy(sp))
    y = np.asarray(spmm_sliced_ell(pk, jnp.ones((64, 3), jnp.float32)))
    assert (y == 0).all()
