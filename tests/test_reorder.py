"""RCM reordering: bandwidth reduction, value preservation, effect on
trisolve level structure and row-lane fill."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import spmv_reference
from sparsematrix_tpu.utils.reorder import (bandwidth, permute_csr,
                                            rcm_permutation)


def _poisson(side):
    Iq = sps.eye(side)
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (side, side))
    return (sps.kron(Iq, T)
            + sps.kron(sps.diags([-1.0, -1.0], [-1, 1], (side, side)),
                       Iq)).tocsr().astype(np.float32)


def test_rcm_recovers_banded_structure(rng):
    # scramble a banded matrix; RCM must bring the bandwidth back down
    side = 24
    n = side * side
    Apo = _poisson(side)
    scram = rng.permutation(n)
    A_s = CSR.from_scipy((Apo[scram, :][:, scram]).tocsr())
    assert bandwidth(A_s) > 4 * side
    perm = rcm_permutation(A_s)
    A_r = permute_csr(A_s, perm)
    assert bandwidth(A_r) <= 2 * side


def test_permute_preserves_values_and_spmv(rng):
    n = 200
    d = (rng.uniform(size=(n, n)) < 0.05) * rng.uniform(-5, 5, (n, n))
    d = d.astype(np.float32)
    A = CSR.fromdense(d)
    perm = rng.permutation(n)
    B = permute_csr(A, perm)
    np.testing.assert_array_equal(np.asarray(B.todense()),
                                  d[perm, :][:, perm])
    # spmv under permutation: (P A P^T)(P x) = P (A x)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    y = np.asarray(spmv_reference(B, jnp.asarray(x[perm])))
    np.testing.assert_allclose(y, (d @ x)[perm], rtol=1e-4, atol=1e-3)


def test_rcm_locality_vs_level_tradeoff(rng):
    """RCM recovers the NATURAL banded order's properties from a scramble:
    bandwidth (→ window locality for the slab layouts) returns to the
    natural order's scale, and the ILU level depth matches the natural
    banded depth.  (A random order has FEWER levels but scatters columns
    across every window — level-minimizing orders are a different tool.)
    """
    from sparsematrix_tpu.ops import ilu0, trisolve_plan

    side = 16
    n = side * side
    Apo = _poisson(side)
    scram = rng.permutation(n)
    A_s = CSR.from_scipy((Apo[scram, :][:, scram]).tocsr())
    perm = rcm_permutation(A_s)
    A_r = permute_csr(A_s, perm)

    def levels(M):
        L, _ = ilu0(M)
        return trisolve_plan(L, lower=True,
                             unit_diagonal=True).rows.shape[0]

    natural = levels(CSR.from_scipy(Apo))
    rcm = levels(A_r)
    assert rcm <= natural + 2
    assert bandwidth(A_r) <= 2 * bandwidth(CSR.from_scipy(Apo))
