"""Codebook-quantized sparse format — parity with the reference's core format.

The reference (`sblas::SparseMatrix<uint8, uint8, float, 0, 8>`,
reference src/sparse/sparse-matrix.h:26, sparse-matrix.cc:315) stores a
sparse weight matrix as a delta-encoded stream of (position-delta, codebook
index) byte pairs over 256-column panels, with values drawn from a ≤255-entry
float table plus an appended sentinel ``val_table[size] = 0`` used for filler
entries (sparse-matrix.cc:29-31,46-51).

Design here:
  * ``CodebookCSR`` — compute layout: CSR structure whose per-entry payload is
    a small integer index into ``val_table`` (sentinel slot appended).
    Padding entries point at the sentinel → contribute 0.  Dequantization is
    a gather ``val_table[val_idx]`` (XLA-fused).
    The delta-stream does not vectorize, so it is *not* the compute layout —
    it is preserved as a **wire codec** (``encode_stream``/``decode_stream``)
    for byte-compatible interchange with the reference encoding
    (encode: sparse-matrix.cc:21-99; decode: sparse-matrix.cc:102-137).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, default_index_dtype, register_sparse_pytree
from .csr import CSR, _expand_rowids

__all__ = [
    "CodebookCSR",
    "encode_stream",
    "decode_stream",
    "CodebookStream",
]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class CodebookCSR(SparseFormat):
    indptr: jnp.ndarray  # (rows+1,) int32
    indices: jnp.ndarray  # (capacity,) int32 column ids
    val_idx: jnp.ndarray  # (capacity,) int32 ∈ [0, table_size]; table_size = sentinel
    val_table: jnp.ndarray  # (table_size+1,) values, sentinel 0 appended
    row_ids: Optional[jnp.ndarray]  # (capacity,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})
    table_size: int = dataclasses.field(metadata={"static": True})

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def data(self):
        """Dequantized per-entry values (gather from the codebook)."""
        return self.val_table[self.val_idx]

    # -- construction ---------------------------------------------------
    @classmethod
    def from_index_matrix(cls, index_matrix, val_table, trans: bool = False,
                          capacity: int | None = None,
                          index_dtype=default_index_dtype):
        """Encode from a dense matrix of codebook indices.

        Mirrors ``CopyForm`` semantics (sparse-matrix.cc:21-99): an entry
        ``v`` denotes value ``val_table[v]`` iff ``0 <= v < len(val_table)``,
        otherwise the entry is zero (not stored).  ``trans=True`` encodes the
        transpose at build time (the ``SblasTrans`` path,
        sparse-matrix.cc:65-98).
        """
        idx = np.asarray(index_matrix)
        table = np.asarray(val_table)
        ts = int(table.shape[0])
        if ts < 1 or ts > 255:
            raise ValueError("val_table size must be in [1, 255]")
        if trans:
            idx = idx.T
        rows, cols = idx.shape
        mask = (idx >= 0) & (idx < ts)
        r, c = np.nonzero(mask)
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
        vi = idx[r, c].astype(np.int64)
        nnz = int(r.shape[0])
        cap = max(nnz, 1) if capacity is None else int(capacity)
        indptr = np.zeros(rows + 1, dtype=np.int64)
        np.add.at(indptr[1:], r, 1)
        indptr = np.cumsum(indptr)
        indices = np.zeros((cap,), dtype=np.int64)
        indices[:nnz] = c
        val_idx = np.full((cap,), ts, dtype=np.int64)  # padding → sentinel
        val_idx[:nnz] = vi
        table_ext = np.concatenate([table, np.zeros((1,), dtype=table.dtype)])
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=jnp.asarray(indices, dtype=index_dtype),
            val_idx=jnp.asarray(val_idx, dtype=index_dtype),
            val_table=jnp.asarray(table_ext),
            row_ids=jnp.asarray(_expand_rowids(indptr, cap, rows), dtype=index_dtype),
            shape=(rows, cols),
            nnz=nnz,
            table_size=ts,
        )

    # -- decode ---------------------------------------------------------
    def to_csr(self) -> CSR:
        return CSR(
            indptr=self.indptr,
            indices=self.indices,
            data=self.data,
            row_ids=self.row_ids,
            shape=self.shape,
            nnz=self.nnz,
        )

    def todense(self):
        return self.to_csr().todense()

    def transpose(self) -> "CodebookCSR":
        """Host-side transpose preserving quantization."""
        import scipy.sparse as sp

        r = np.asarray(self.row_ids)[: self.nnz]
        c = np.asarray(self.indices)[: self.nnz]
        vi = np.asarray(self.val_idx)[: self.nnz]
        # transpose the *index* matrix, then re-encode
        m = sp.coo_matrix((vi + 1, (c, r)), shape=(self.shape[1], self.shape[0])).toarray()
        idx_mtx = np.where(m > 0, m - 1, self.table_size)  # table_size = "zero"
        return CodebookCSR.from_index_matrix(
            idx_mtx, np.asarray(self.val_table)[: self.table_size],
            capacity=self.capacity,
        )

    @property
    def T(self) -> "CodebookCSR":
        return self.transpose()


# ---------------------------------------------------------------------------
# Wire codec: the reference's delta-encoded byte stream.
# ---------------------------------------------------------------------------

PANEL_COLS_SHIFT = 8  # SBLAS_BLOCK_COL_SHIFT (reference src/sparse/kernel.h:26)
PANEL_COLS = 1 << PANEL_COLS_SHIFT
DELTA_MAX = 255  # zero_pad_interval for uint8 PosIndex_t


@dataclasses.dataclass
class CodebookStream:
    """Host-side container for the reference wire encoding.

    ``pos_delta``/``val_idx`` are parallel uint8 streams; ``panel_origins``
    holds each non-empty panel's (row_off, col_off) and ``panel_bounds`` the
    [start, end) ranges into the streams — mirroring ``block_bounds_`` /
    ``block_index_bounds_`` (sparse-matrix.h:46-52).
    """

    pos_delta: np.ndarray  # (stream_len,) uint8
    val_idx: np.ndarray  # (stream_len,) uint8
    val_table: np.ndarray  # (table_size+1,) float32, sentinel 0 appended
    panel_origins: np.ndarray  # (num_panels, 2) int32
    panel_bounds: np.ndarray  # (num_panels, 2) int32
    shape: Tuple[int, int]

    @property
    def nbytes(self) -> int:
        return (
            self.pos_delta.nbytes
            + self.val_idx.nbytes
            + self.val_table.nbytes
            + self.panel_origins.nbytes
            + self.panel_bounds.nbytes
        )


def encode_stream(index_matrix, val_table, trans: bool = False) -> CodebookStream:
    """Delta-encode a dense index matrix into the reference wire format.

    Semantics of CopyForm (sparse-matrix.cc:21-99): scan 256-column panels
    (full-height, since block_row_shift=0) row-major; store each nonzero's
    in-panel linear position (``ii*256 + jj``) as a delta from the previous
    stored position (init 0), bridging deltas > 255 with filler pairs
    ``(255, sentinel_index)``.

    Uses the native C++ codec (``native/codec.cc``) when available; the
    numpy path below is the behavioral reference.
    """
    idx = np.asarray(index_matrix)
    table = np.asarray(val_table, dtype=np.float32)
    ts = int(table.shape[0])
    if ts < 1 or ts > 255:
        raise ValueError("val_table size must be in [1, 255]")
    if trans:
        idx = idx.T
    rows, cols = idx.shape

    native = _encode_stream_native(idx, table, ts)
    if native is not None:
        return native
    pos_stream: list[int] = []
    val_stream: list[int] = []
    origins = []
    bounds = []
    for j0 in range(0, cols, PANEL_COLS):
        left = len(pos_stream)
        prev = 0
        panel = idx[:, j0 : j0 + PANEL_COLS]
        mask = (panel >= 0) & (panel < ts)
        rr, cc = np.nonzero(mask)
        order = np.lexsort((cc, rr))
        rr, cc = rr[order], cc[order]
        lin = rr * PANEL_COLS + cc
        for p, v in zip(lin.tolist(), panel[rr, cc].tolist()):
            d = int(p) - prev
            while d > DELTA_MAX:
                pos_stream.append(DELTA_MAX)
                val_stream.append(ts)
                d -= DELTA_MAX
            pos_stream.append(d)
            val_stream.append(int(v))
            prev = int(p)
        if len(pos_stream) != left:
            origins.append((0, j0))
            bounds.append((left, len(pos_stream)))
    return CodebookStream(
        pos_delta=np.asarray(pos_stream, dtype=np.uint8),
        val_idx=np.asarray(val_stream, dtype=np.uint8),
        val_table=np.concatenate([table, np.zeros((1,), np.float32)]),
        panel_origins=np.asarray(origins, dtype=np.int32).reshape(-1, 2),
        panel_bounds=np.asarray(bounds, dtype=np.int32).reshape(-1, 2),
        shape=(rows, cols),
    )


def _encode_stream_native(idx, table, ts: int) -> "CodebookStream | None":
    from .. import native as native_mod

    lib = native_mod.get_lib()
    if lib is None:
        return None
    import ctypes

    rows, cols = idx.shape
    idx32 = np.ascontiguousarray(idx, dtype=np.int32)
    # worst case: every entry stored + a filler per entry + per-panel slack
    nnz_ub = int(((idx32 >= 0) & (idx32 < ts)).sum())
    cap = 2 * nnz_ub + (cols // PANEL_COLS + 2) * (rows * PANEL_COLS // 255 + 2)
    pos = np.empty(cap, dtype=np.uint8)
    val = np.empty(cap, dtype=np.uint8)
    max_panels = cols // PANEL_COLS + 1
    origins = np.empty(2 * max_panels, dtype=np.int32)
    bounds = np.empty(2 * max_panels, dtype=np.int32)
    n_panels = ctypes.c_int32(0)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.smtpu_encode_stream(
        p(idx32, ctypes.c_int32), rows, cols, ts,
        p(pos, ctypes.c_uint8), p(val, ctypes.c_uint8), cap,
        p(origins, ctypes.c_int32), p(bounds, ctypes.c_int32),
        ctypes.byref(n_panels),
    )
    if n < 0:
        return None
    np_ = int(n_panels.value)
    return CodebookStream(
        pos_delta=pos[:n].copy(),
        val_idx=val[:n].copy(),
        val_table=np.concatenate([table, np.zeros((1,), np.float32)]),
        panel_origins=origins[: 2 * np_].reshape(-1, 2).copy(),
        panel_bounds=bounds[: 2 * np_].reshape(-1, 2).copy(),
        shape=(rows, cols),
    )


def decode_stream_native(stream: CodebookStream) -> "np.ndarray | None":
    """Native decode; returns None if the library is unavailable."""
    from .. import native as native_mod

    lib = native_mod.get_lib()
    if lib is None:
        return None
    import ctypes

    rows, cols = stream.shape
    out = np.zeros((rows, cols), dtype=np.float32)
    ts = stream.val_table.shape[0] - 1
    origins = np.ascontiguousarray(stream.panel_origins.reshape(-1), np.int32)
    bounds = np.ascontiguousarray(stream.panel_bounds.reshape(-1), np.int32)
    table = np.ascontiguousarray(stream.val_table, np.float32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.smtpu_decode_stream(
        p(stream.pos_delta, ctypes.c_uint8), p(stream.val_idx, ctypes.c_uint8),
        stream.pos_delta.shape[0], p(table, ctypes.c_float), ts,
        p(origins, ctypes.c_int32), p(bounds, ctypes.c_int32),
        stream.panel_origins.shape[0], p(out, ctypes.c_float), rows, cols,
    )
    return out


def decode_stream(stream: CodebookStream, trans: bool = False) -> np.ndarray:
    """Decode a wire stream to dense.  ``trans=True`` emits the transposed
    orientation, completing the ``CopyTo`` contract (the reference can
    scatter either way, sparse-matrix.cc:108-136); output shape is then
    ``(cols, rows)``."""
    native = decode_stream_native(stream)
    if native is not None:
        # native decodes the direct orientation; the transposed emit is the
        # same scatter with the axes swapped
        return np.ascontiguousarray(native.T) if trans else native
    return _decode_stream_numpy(stream, trans=trans)


def _decode_stream_numpy(stream: CodebookStream, trans: bool = False) -> np.ndarray:
    """Decode a wire stream to a dense float matrix (CopyTo analogue,
    sparse-matrix.cc:102-136): per panel, prefix-sum the deltas, skip
    sentinel entries, scatter ``val_table[val_idx]`` — to ``[row, col]``
    directly or ``[col, row]`` for the transposed emit
    (sparse-matrix.cc:124-135)."""
    rows, cols = stream.shape
    shape = (cols, rows) if trans else (rows, cols)
    out = np.zeros(shape, dtype=stream.val_table.dtype)
    ts = stream.val_table.shape[0] - 1
    for (r0, c0), (start, end) in zip(stream.panel_origins, stream.panel_bounds):
        deltas = stream.pos_delta[start:end].astype(np.int64)
        vids = stream.val_idx[start:end]
        pos = np.cumsum(deltas)
        keep = vids != ts
        pos = pos[keep]
        vids = vids[keep]
        rr = r0 + (pos >> PANEL_COLS_SHIFT)
        cc = c0 + (pos & (PANEL_COLS - 1))
        if trans:
            out[cc, rr] = stream.val_table[vids]
        else:
            out[rr, cc] = stream.val_table[vids]
    return out


def stream_to_codebook_csr(stream: CodebookStream, capacity: int | None = None) -> CodebookCSR:
    """Convert a wire stream into the compute layout."""
    dense_idx = _stream_to_index_matrix(stream)
    return CodebookCSR.from_index_matrix(
        dense_idx, stream.val_table[:-1], capacity=capacity
    )


def _stream_to_index_matrix(stream: CodebookStream) -> np.ndarray:
    rows, cols = stream.shape
    ts = stream.val_table.shape[0] - 1
    out = np.full((rows, cols), ts, dtype=np.int64)  # ts = "zero" index
    for (r0, c0), (start, end) in zip(stream.panel_origins, stream.panel_bounds):
        deltas = stream.pos_delta[start:end].astype(np.int64)
        vids = stream.val_idx[start:end].astype(np.int64)
        pos = np.cumsum(deltas)
        keep = vids != ts
        pos = pos[keep]
        vids = vids[keep]
        rr = r0 + (pos >> PANEL_COLS_SHIFT)
        cc = c0 + (pos & (PANEL_COLS - 1))
        out[rr, cc] = vids
    return out
