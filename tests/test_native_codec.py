"""Native C++ codec vs the numpy behavioral reference — bit-exact equality
(the lesson of the reference's AVX2 register-store bug, SURVEY §6: optimized
codec must be tested bit-exactly against the naive path)."""
import numpy as np
import pytest

from sparsematrix_tpu import native
from sparsematrix_tpu.formats import codebook as cb
from sparsematrix_tpu.utils.testutils import gen_sparse_index_matrix

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="native codec unavailable (no g++)"
)


def _numpy_encode(idx, table):
    """Force the numpy path regardless of native availability."""
    saved = cb._encode_stream_native
    cb._encode_stream_native = lambda *a, **k: None
    try:
        return cb.encode_stream(idx, table)
    finally:
        cb._encode_stream_native = saved


@pytest.mark.parametrize("shape", [(64, 100), (511, 1023), (3, 2000)])
def test_encode_native_matches_numpy(rng, shape):
    idx, table = gen_sparse_index_matrix(rng, *shape, density=0.25,
                                         table_size=63)
    s_np = _numpy_encode(idx, table)
    s_c = cb.encode_stream(idx, table)
    np.testing.assert_array_equal(s_c.pos_delta, s_np.pos_delta)
    np.testing.assert_array_equal(s_c.val_idx, s_np.val_idx)
    np.testing.assert_array_equal(s_c.panel_origins, s_np.panel_origins)
    np.testing.assert_array_equal(s_c.panel_bounds, s_np.panel_bounds)


def test_decode_native_matches_numpy(rng):
    idx, table = gen_sparse_index_matrix(rng, 200, 700, density=0.3,
                                         table_size=31)
    stream = cb.encode_stream(idx, table)
    d_np = cb._decode_stream_numpy(stream)
    d_c = cb.decode_stream_native(stream)
    np.testing.assert_array_equal(d_c, d_np)


def test_long_gap_fillers_native():
    idx = np.full((2, 1500), 99, dtype=np.int64)
    idx[0, 0] = 0
    idx[1, 1499] = 1
    table = np.array([5.0, -7.0], dtype=np.float32)
    s_np = _numpy_encode(idx, table)
    s_c = cb.encode_stream(idx, table)
    np.testing.assert_array_equal(s_c.pos_delta, s_np.pos_delta)
    np.testing.assert_array_equal(s_c.val_idx, s_np.val_idx)
    np.testing.assert_array_equal(cb.decode_stream(s_c),
                                  cb._decode_stream_numpy(s_np))


@pytest.mark.parametrize("trans", [False, True])
def test_decode_native_matches_numpy_both_orientations(rng, trans):
    idx, table = gen_sparse_index_matrix(rng, 150, 640, density=0.35,
                                         table_size=63)
    stream = cb.encode_stream(idx, table)
    d_np = cb._decode_stream_numpy(stream, trans=trans)
    d_c = cb.decode_stream(stream, trans=trans)  # native when available
    np.testing.assert_array_equal(d_c, d_np)
