"""Encode→decode roundtrip + idempotency for every format.

Mirrors the reference's SelfTest strategy
(reference src/sparse/sparse-matrix.cc:247-311): large random matrix,
odd shapes (1023×511-style to exercise remainder/padding paths), exact
equality on roundtrip — legitimate because encode/decode move values without
arithmetic.
"""
import numpy as np
import pytest

from sparsematrix_tpu.formats import (
    BSR,
    COO,
    CSR,
    ELL,
    BlockedELL,
    bsr_to_csr,
    coo_to_csr,
    csr_to_blocked_ell,
    csr_to_bsr,
    csr_to_coo,
    csr_to_ell,
    ell_to_csr,
)
from sparsematrix_tpu.utils.testutils import gen_random_dense_sparse

SHAPES = [(7, 5), (64, 64), (127, 65), (257, 130)]


def _rand(rng, shape, density=0.25):
    return gen_random_dense_sparse(rng, *shape, density=density)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cls", [COO, CSR, ELL])
def test_dense_roundtrip_exact(rng, cls, shape):
    dense = _rand(rng, shape)
    sp = cls.fromdense(dense)
    out = np.asarray(sp.todense())
    np.testing.assert_array_equal(out, dense)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", [(4, 4), (8, 8)])
def test_bsr_roundtrip_exact(rng, shape, block):
    dense = _rand(rng, shape)
    sp = BSR.fromdense(dense, block_shape=block)
    np.testing.assert_array_equal(np.asarray(sp.todense()), dense)


@pytest.mark.parametrize("shape", [(64, 256), (127, 300)])
@pytest.mark.parametrize("block", [(8, 128), (8, 64)])
def test_blocked_ell_roundtrip_exact(rng, shape, block):
    dense = _rand(rng, shape, density=0.05)
    sp = BlockedELL.fromdense(dense, block_shape=block)
    np.testing.assert_array_equal(np.asarray(sp.todense()), dense)


def test_padding_capacity_is_harmless(rng):
    dense = _rand(rng, (33, 47))
    nnz = int((dense != 0).sum())
    for sp in (
        COO.fromdense(dense, capacity=nnz + 100),
        CSR.fromdense(dense, capacity=nnz + 100),
    ):
        np.testing.assert_array_equal(np.asarray(sp.todense()), dense)


def test_conversion_chain_exact(rng):
    dense = _rand(rng, (96, 200), density=0.1)
    csr = CSR.fromdense(dense)
    for converted in (
        coo_to_csr(csr_to_coo(csr)),
        ell_to_csr(csr_to_ell(csr)[0]),
        bsr_to_csr(csr_to_bsr(csr, block_shape=(8, 8))),
        csr_to_blocked_ell(csr, block_shape=(8, 64)),
    ):
        np.testing.assert_array_equal(np.asarray(converted.todense()), dense)


def test_ell_row_sort_permutation(rng):
    dense = _rand(rng, (50, 80), density=0.2)
    csr = CSR.fromdense(dense)
    ell, perm = csr_to_ell(csr, sort_rows=True)
    out = np.zeros_like(dense)
    out[perm] = np.asarray(ell.todense())
    np.testing.assert_array_equal(out, dense)


def test_encode_idempotent(rng):
    # re-encoding an encoded/decoded matrix is the identity
    # (mirrors sparse-matrix.cc:280-283)
    dense = _rand(rng, (65, 129))
    a = CSR.fromdense(dense)
    b = CSR.fromdense(np.asarray(a.todense()))
    np.testing.assert_array_equal(np.asarray(a.todense()), np.asarray(b.todense()))


def test_transpose(rng):
    dense = _rand(rng, (31, 57))
    for cls in (COO, CSR):
        sp = cls.fromdense(dense)
        np.testing.assert_array_equal(np.asarray(sp.T.todense()), dense.T)


def test_scipy_bridge(rng):
    import scipy.sparse as s

    dense = _rand(rng, (40, 30))
    csr = CSR.fromdense(dense)
    back = csr.to_scipy().toarray()
    np.testing.assert_array_equal(back, dense)
    again = CSR.from_scipy(s.csr_matrix(dense))
    np.testing.assert_array_equal(np.asarray(again.todense()), dense)
