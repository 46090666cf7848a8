"""Codebook format: golden micro-cases, wire-codec roundtrip, add_mat_mat.

Replicates the *strategy* of the reference SelfTest
(reference src/sparse/sparse-matrix.cc:210-313): hand-computed golden
micro-case, both-orientation encode, roundtrip identity on a large random
matrix, re-encode idempotency — with independently chosen data.
"""
import jax
import jax.numpy as jnp
import numpy as np

from sparsematrix_tpu.formats import (
    CodebookCSR,
    decode_stream,
    encode_stream,
    stream_to_codebook_csr,
)
from sparsematrix_tpu.ops import add_mat_mat
from sparsematrix_tpu.utils.testutils import (
    gen_matrix_random,
    gen_sparse_index_matrix,
    relative_check,
)

# --- golden micro-case (hand-computed) -------------------------------------
# table = [2.0, -1.5, 0.5]; sentinel index = 3 (and anything >= 3) = zero
# index matrix (3x4):
#   [0, 3, 1, 3]      values: [ 2.0, 0, -1.5, 0 ]
#   [3, 2, 3, 0]              [ 0, 0.5, 0, 2.0 ]
#   [1, 3, 3, 3]              [-1.5, 0, 0, 0 ]
GOLD_TABLE = np.array([2.0, -1.5, 0.5], dtype=np.float32)
GOLD_IDX = np.array(
    [[0, 3, 1, 3],
     [3, 2, 3, 0],
     [1, 3, 3, 3]], dtype=np.int64)
GOLD_DENSE = np.array(
    [[2.0, 0.0, -1.5, 0.0],
     [0.0, 0.5, 0.0, 2.0],
     [-1.5, 0.0, 0.0, 0.0]], dtype=np.float32)


def test_golden_decode():
    A = CodebookCSR.from_index_matrix(GOLD_IDX, GOLD_TABLE)
    np.testing.assert_array_equal(np.asarray(A.todense()), GOLD_DENSE)
    assert A.nnz == 5
    assert A.table_size == 3


def test_golden_decode_trans():
    A = CodebookCSR.from_index_matrix(GOLD_IDX, GOLD_TABLE, trans=True)
    np.testing.assert_array_equal(np.asarray(A.todense()), GOLD_DENSE.T)


def test_golden_add_mat_mat():
    # A_dense (2x3) @ GOLD_DENSE (3x4), alpha=2, beta=0.5, hand-checkable
    a = np.array([[1.0, 2.0, 3.0],
                  [0.0, -1.0, 1.0]], dtype=np.float32)
    c0 = np.ones((2, 4), dtype=np.float32)
    expected = 0.5 * c0 + 2.0 * (a @ GOLD_DENSE)
    # B stored pre-transposed, as the reference encodes it (SblasTrans)
    b_t = CodebookCSR.from_index_matrix(GOLD_IDX, GOLD_TABLE, trans=True)
    got = np.asarray(
        jax.jit(add_mat_mat, static_argnames=())(
            jnp.asarray(a), b_t, jnp.asarray(c0), 2.0, 0.5
        )
    )
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-5)


def test_wire_codec_roundtrip_random(rng):
    # large, odd-shaped (remainder panels), mirrors SelfTest's 1023x511 case
    idx_mtx, table = gen_sparse_index_matrix(rng, 511, 1023, density=0.25,
                                             table_size=63)
    stream = encode_stream(idx_mtx, table)
    dense = decode_stream(stream)
    A = CodebookCSR.from_index_matrix(idx_mtx, table)
    np.testing.assert_array_equal(dense, np.asarray(A.todense()))
    # stream → compute layout
    A2 = stream_to_codebook_csr(stream)
    np.testing.assert_array_equal(np.asarray(A2.todense()), dense)
    # compression: ~2 bytes/nnz plus fillers — must be well below CSR's 8B/nnz
    assert stream.pos_delta.shape[0] >= A.nnz
    assert stream.pos_delta.shape[0] <= A.nnz * 1.25  # filler overhead bound


def test_wire_codec_trans_matches_transpose(rng):
    idx_mtx, table = gen_sparse_index_matrix(rng, 37, 300, density=0.3,
                                             table_size=31)
    s_t = encode_stream(idx_mtx, table, trans=True)
    np.testing.assert_array_equal(decode_stream(s_t),
                                  decode_stream(encode_stream(idx_mtx, table)).T)


def test_wire_codec_sparse_long_gaps():
    # deltas > 255 must be bridged by fillers
    idx = np.full((2, 1000), 99, dtype=np.int64)  # all zero (out of table)
    idx[0, 0] = 0
    idx[1, 999] = 1
    table = np.array([5.0, -7.0], dtype=np.float32)
    stream = encode_stream(idx, table)
    dense = decode_stream(stream)
    expected = np.zeros((2, 1000), dtype=np.float32)
    expected[0, 0] = 5.0
    expected[1, 999] = -7.0
    np.testing.assert_array_equal(dense, expected)
    assert (stream.val_idx == 2).any()  # sentinel fillers present


def test_reference_benchmark_shape_check(rng):
    """The reference's headline workload at reduced size: dense A (m×k) @
    codebook-sparse B (k×n), vs dense oracle with the reference tolerance
    policy (blas_test.h:161-182)."""
    m, n, k = 29, 127, 255
    a = gen_matrix_random(rng, m, k)
    idx_mtx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                             table_size=255)
    b_t = CodebookCSR.from_index_matrix(idx_mtx, table, trans=True)
    b_dense = np.asarray(b_t.todense()).T
    oracle = a.astype(np.float64) @ b_dense.astype(np.float64)
    got = np.asarray(add_mat_mat(jnp.asarray(a), b_t, alpha=1.0))
    assert relative_check(got, oracle)
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-1)


def test_transpose_roundtrip(rng):
    idx_mtx, table = gen_sparse_index_matrix(rng, 40, 60, density=0.2,
                                             table_size=15)
    A = CodebookCSR.from_index_matrix(idx_mtx, table)
    np.testing.assert_array_equal(np.asarray(A.T.todense()),
                                  np.asarray(A.todense()).T)
    np.testing.assert_array_equal(np.asarray(A.T.T.todense()),
                                  np.asarray(A.todense()))


def test_int8_activation_gemm(rng):
    """The wgemm_plus analogue: int8 activations x int8 codebook on the
    integer product path, checked at the reference's 0.1 relative policy."""
    from sparsematrix_tpu.formats import CodebookDense
    from sparsematrix_tpu.ops import add_mat_mat_int8, quantize_codebook
    from sparsematrix_tpu.utils.testutils import (
        gen_matrix_random,
        gen_sparse_index_matrix,
        relative_check,
    )

    m, n, k = 24, 120, 200
    idx, table = gen_sparse_index_matrix(rng, n, k, density=0.3,
                                         table_size=63)
    B_t = CodebookDense.from_index_matrix(idx, table)
    Bq = quantize_codebook(B_t)
    a = gen_matrix_random(rng, m, k)
    c = gen_matrix_random(rng, m, n)
    got = np.asarray(jax.jit(
        lambda aa, cc: add_mat_mat_int8(aa, Bq, cc, alpha=1.0, beta=1.0)
    )(jnp.asarray(a), jnp.asarray(c)))
    b_dense = np.asarray(B_t.todense()).T
    want = c + a.astype(np.float64) @ b_dense.astype(np.float64)
    # int8 x int8 is a quantized path: judge error against the output
    # scale (near-zero entries of a +/-1e6-range product are meaningless
    # in relative terms)
    scale = np.abs(want).max()
    rel = np.abs(got - want) / (np.abs(want) + 0.05 * scale)
    assert np.median(rel) < 0.03
    assert np.quantile(rel, 0.99) < 0.15


def test_codebook_csr_auto_converts_to_fused(rng):
    """spmm(auto) on a concrete CodebookCSR converts+caches a CodebookDense
    so the default path runs the fused dequant + dense dot (no caller-side
    prep)."""
    from sparsematrix_tpu.ops import spmm as spmm_op
    import importlib

    spmm_mod = importlib.import_module("sparsematrix_tpu.ops.spmm")
    from sparsematrix_tpu.utils.testutils import gen_sparse_index_matrix

    idx, table = gen_sparse_index_matrix(rng, 40, 300, density=0.25,
                                         table_size=31)
    A = CodebookCSR.from_index_matrix(idx, table)
    X = jnp.asarray(rng.standard_normal((300, 8)).astype(np.float32))
    spmm_mod._CBD_CACHE.clear()
    got = np.asarray(spmm_op(A, X))
    assert len(spmm_mod._CBD_CACHE) == 1  # converted and cached
    want = np.asarray(A.todense()).astype(np.float64) @ np.asarray(X)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.5)
    got2 = np.asarray(spmm_op(A, X))
    assert len(spmm_mod._CBD_CACHE) == 1
    np.testing.assert_allclose(got2, got, atol=0)


def test_int16_activation_gemm(rng):
    """The direct cblas_wgemm_plus analogue (int16 activations,
    cblas.h:252-257): double-pumped int8 planes.  Must be sharply
    more accurate than the int8 path on the same operands."""
    from sparsematrix_tpu.formats import CodebookDense
    from sparsematrix_tpu.ops import add_mat_mat_int8, quantize_codebook
    from sparsematrix_tpu.ops.quantized import add_mat_mat_int16
    from sparsematrix_tpu.utils.testutils import (
        gen_matrix_random,
        gen_sparse_index_matrix,
    )

    m, n, k = 24, 120, 200
    idx, table = gen_sparse_index_matrix(rng, n, k, density=0.3,
                                         table_size=63)
    B_t = CodebookDense.from_index_matrix(idx, table)
    Bq = quantize_codebook(B_t)
    a = gen_matrix_random(rng, m, k)
    c = gen_matrix_random(rng, m, n)
    got16 = np.asarray(jax.jit(
        lambda aa, cc: add_mat_mat_int16(aa, Bq, cc, alpha=1.0, beta=1.0)
    )(jnp.asarray(a), jnp.asarray(c)))
    got8 = np.asarray(jax.jit(
        lambda aa, cc: add_mat_mat_int8(aa, Bq, cc, alpha=1.0, beta=1.0)
    )(jnp.asarray(a), jnp.asarray(c)))
    b_dense = np.asarray(B_t.todense()).T
    want = c + a.astype(np.float64) @ b_dense.astype(np.float64)
    scale = np.abs(want).max()
    rel16 = np.abs(got16 - want) / (np.abs(want) + 0.05 * scale)
    rel8 = np.abs(got8 - want) / (np.abs(want) + 0.05 * scale)
    # residual error is the int8 TABLE quantization only; activations
    # contribute ~1/256 of the int8 path's share
    assert np.median(rel16) < 0.02
    assert np.quantile(rel16, 0.99) < 0.08
    assert np.mean(rel16) < np.mean(rel8)


def test_int16_activation_gemm_alpha_beta_zero(rng):
    from sparsematrix_tpu.formats import CodebookDense
    from sparsematrix_tpu.ops import quantize_codebook
    from sparsematrix_tpu.ops.quantized import add_mat_mat_int16
    from sparsematrix_tpu.utils.testutils import (
        gen_matrix_random,
        gen_sparse_index_matrix,
    )

    idx, table = gen_sparse_index_matrix(rng, 50, 70, density=0.25,
                                         table_size=31)
    Bq = quantize_codebook(CodebookDense.from_index_matrix(idx, table))
    a = gen_matrix_random(rng, 8, 70)
    got = np.asarray(add_mat_mat_int16(jnp.asarray(a), Bq, alpha=2.5))
    b_dense = np.asarray(
        CodebookDense.from_index_matrix(idx, table).todense()).T
    want = 2.5 * (a.astype(np.float64) @ b_dense.astype(np.float64))
    scale = max(np.abs(want).max(), 1e-9)
    assert np.abs(got - want).max() / scale < 0.02
