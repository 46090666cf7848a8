// Native host codec for the codebook wire format and CSR assembly.
//
// The reference implements its encode/decode in C++ (CopyForm/CopyTo,
// reference src/sparse/sparse-matrix.cc:21-137); this is the
// framework's analogue: the *device* math lives in XLA, but the
// host-side stream codec — a sequential, branchy byte-stream transform that
// vectorizes poorly in numpy — is native C++ exposed via a C ABI (ctypes).
//
// Wire format (must match formats/codebook.py encode_stream):
//   * full-height panels of 256 columns (block_col_shift = 8)
//   * per panel: nonzeros scanned row-major; in-panel linear position
//     p = row*256 + col stored as delta from previous position (init 0)
//   * deltas > 255 bridged by filler pairs (255, table_size)
//   * per non-empty panel: (row_off=0, col_off) origin and [start, end)
//     bounds into the streams.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int kPanelShift = 8;
constexpr int kPanelCols = 1 << kPanelShift;
constexpr int kDeltaMax = 255;
}  // namespace

extern "C" {

// Encode a dense index matrix (row-major, int32; entries outside
// [0, table_size) mean zero) into the delta stream.
// Returns the stream length, or -1 if out_cap is too small.
// panel buffers must hold ceil(cols/256) entries each (origins: 2 ints per
// panel; bounds: 2 ints per panel); *n_panels receives the count.
long smtpu_encode_stream(const int32_t* idx, long rows, long cols,
                         int32_t table_size, uint8_t* pos_out,
                         uint8_t* val_out, long out_cap,
                         int32_t* panel_origins, int32_t* panel_bounds,
                         int32_t* n_panels) {
  long w = 0;
  int32_t np = 0;
  for (long j0 = 0; j0 < cols; j0 += kPanelCols) {
    const long left = w;
    long prev = 0;
    const long cw = (cols - j0 < kPanelCols) ? cols - j0 : kPanelCols;
    for (long i = 0; i < rows; ++i) {
      const int32_t* prow = idx + i * cols + j0;
      const long base = i * kPanelCols;
      for (long jj = 0; jj < cw; ++jj) {
        const int32_t v = prow[jj];
        if (v < 0 || v >= table_size) continue;
        long d = base + jj - prev;
        while (d > kDeltaMax) {
          if (w >= out_cap) return -1;
          pos_out[w] = kDeltaMax;
          val_out[w] = static_cast<uint8_t>(table_size);
          ++w;
          d -= kDeltaMax;
        }
        if (w >= out_cap) return -1;
        pos_out[w] = static_cast<uint8_t>(d);
        val_out[w] = static_cast<uint8_t>(v);
        ++w;
        prev = base + jj;
      }
    }
    if (w != left) {
      panel_origins[2 * np] = 0;
      panel_origins[2 * np + 1] = static_cast<int32_t>(j0);
      panel_bounds[2 * np] = static_cast<int32_t>(left);
      panel_bounds[2 * np + 1] = static_cast<int32_t>(w);
      ++np;
    }
  }
  *n_panels = np;
  return w;
}

// Decode the stream into a dense row-major float matrix (zero-filled first).
// Returns the number of real (non-filler) entries written.
long smtpu_decode_stream(const uint8_t* pos, const uint8_t* val, long n,
                         const float* table, int32_t table_size,
                         const int32_t* panel_origins,
                         const int32_t* panel_bounds, int32_t n_panels,
                         float* out, long rows, long cols) {
  (void)n;
  std::memset(out, 0, sizeof(float) * rows * cols);
  long written = 0;
  for (int32_t p = 0; p < n_panels; ++p) {
    const long r0 = panel_origins[2 * p];
    const long c0 = panel_origins[2 * p + 1];
    const long start = panel_bounds[2 * p];
    const long end = panel_bounds[2 * p + 1];
    long off = 0;
    for (long s = start; s < end; ++s) {
      off += pos[s];
      if (val[s] == table_size) continue;  // filler
      const long r = r0 + (off >> kPanelShift);
      const long c = c0 + (off & (kPanelCols - 1));
      out[r * cols + c] = table[val[s]];
      ++written;
    }
  }
  return written;
}

// Decode the stream directly into COO triplets (row, col, val_idx) —
// feeding the compute layout without a dense intermediate.
// Returns nnz, or -1 if cap too small.
long smtpu_decode_stream_coo(const uint8_t* pos, const uint8_t* val, long n,
                             int32_t table_size,
                             const int32_t* panel_origins,
                             const int32_t* panel_bounds, int32_t n_panels,
                             int32_t* rows_out, int32_t* cols_out,
                             int32_t* vidx_out, long cap) {
  (void)n;
  long w = 0;
  for (int32_t p = 0; p < n_panels; ++p) {
    const long r0 = panel_origins[2 * p];
    const long c0 = panel_origins[2 * p + 1];
    const long start = panel_bounds[2 * p];
    const long end = panel_bounds[2 * p + 1];
    long off = 0;
    for (long s = start; s < end; ++s) {
      off += pos[s];
      if (val[s] == table_size) continue;
      if (w >= cap) return -1;
      rows_out[w] = static_cast<int32_t>(r0 + (off >> kPanelShift));
      cols_out[w] = static_cast<int32_t>(c0 + (off & (kPanelCols - 1)));
      vidx_out[w] = val[s];
      ++w;
    }
  }
  return w;
}

// CSR assembly from row-major dense index matrix: counts nonzero (in-table)
// entries per row and emits indptr/indices/val_idx in one pass.
// Returns nnz, or -1 if cap too small.
long smtpu_index_matrix_to_csr(const int32_t* idx, long rows, long cols,
                               int32_t table_size, int64_t* indptr,
                               int32_t* indices, int32_t* vidx, long cap) {
  long w = 0;
  indptr[0] = 0;
  for (long i = 0; i < rows; ++i) {
    const int32_t* prow = idx + i * cols;
    for (long j = 0; j < cols; ++j) {
      const int32_t v = prow[j];
      if (v < 0 || v >= table_size) continue;
      if (w >= cap) return -1;
      indices[w] = static_cast<int32_t>(j);
      vidx[w] = v;
      ++w;
    }
    indptr[i + 1] = w;
  }
  return w;
}

}  // extern "C"

extern "C" {

// ILU(0) factorization in place on CSR (sorted indices, fp64 values).
// IKJ restricted to the pattern; the inner update is a two-pointer merge
// of the sorted k-row/i-row tails (no hash lookups).  Host build-time
// setup, like the encode phase.
// Returns 0 on success, -1-i for a missing diagonal at row i,
// and -(n+1+k) for a zero pivot at row k.
long smtpu_ilu0(const int64_t* indptr, const int32_t* indices, double* a,
                long n) {
  std::vector<long> dpos(n);
  for (long i = 0; i < n; ++i) {
    const int32_t* lo = indices + indptr[i];
    const int32_t* hi = indices + indptr[i + 1];
    const int32_t* it = std::lower_bound(lo, hi, static_cast<int32_t>(i));
    if (it == hi || *it != i) return -1 - i;
    dpos[i] = indptr[i] + (it - lo);
  }
  for (long i = 1; i < n; ++i) {
    for (long s = indptr[i]; s < indptr[i + 1]; ++s) {
      const long k = indices[s];
      if (k >= i) break;
      const double piv = a[dpos[k]];
      if (piv == 0.0) return -(n + 1 + k);
      const double lik = a[s] / piv;
      a[s] = lik;
      long t = dpos[k] + 1;  // first j > k in row k
      long p = s + 1;        // row i tail (all j > k)
      const long tend = indptr[k + 1], pend = indptr[i + 1];
      while (t < tend && p < pend) {
        if (indices[t] < indices[p]) ++t;
        else if (indices[t] > indices[p]) ++p;
        else a[p++] -= lik * a[t++];
      }
    }
  }
  return 0;
}

// IC(0): incomplete Cholesky on the fixed pattern of tril(A).  CSR must
// have sorted indices with the diagonal present (last entry of each row).
// a[] holds tril(A) values on entry and L values on exit (row-wise
// up-looking walk; the row-i/row-j dot over columns < j is a two-pointer
// merge, mirroring smtpu_ilu0's update loop).
// Returns 0 on success, -1-i for a missing diagonal at row i, and
// -(n+1+i) for a non-positive pivot at row i (matrix not SPD-compatible).
long smtpu_ic0(const int64_t* indptr, const int32_t* indices, double* a,
               long n) {
  for (long i = 0; i < n; ++i) {
    const long end = indptr[i + 1];
    if (end == indptr[i] || indices[end - 1] != i) return -1 - i;
    for (long s = indptr[i]; s < end; ++s) {
      const long j = indices[s];
      // dot of rows i and j over columns < j; both diagonals are the
      // final entries of their rows, so the merge bounds exclude them
      double sum = 0.0;
      long p = indptr[i];
      long t = indptr[j];
      const long tend = indptr[j + 1] - 1;
      while (p < s && t < tend) {
        if (indices[p] < indices[t]) ++p;
        else if (indices[p] > indices[t]) ++t;
        else sum += a[p++] * a[t++];
      }
      if (j < i) {
        const double piv = a[tend];  // L[j][j]
        if (piv <= 0.0) return -(n + 1 + j);
        a[s] = (a[s] - sum) / piv;
      } else {  // j == i: the diagonal closes the row
        const double d = a[s] - sum;
        if (d <= 0.0) return -(n + 1 + i);
        a[s] = std::sqrt(d);
      }
    }
  }
  return 0;
}

}  // extern "C"
