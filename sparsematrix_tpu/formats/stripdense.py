"""StripDense — locally-densified row strips for band-local matrices.

An answer to DIA/banded storage: a band-local matrix restricted to a
128-row strip touches only a narrow, contiguous column window — so each
strip can be stored DENSE at that window, and SpMV/SpMM become one
batched (n_strips, 128, width) × (n_strips, width, k) matmul that XLA
hands to the batched dense-product path.
Padding inside a strip is explicit zeros (harmless under accumulation,
the sentinel-zero stance of reference src/sparse/sparse-matrix.cc:29-31);
the only sparse machinery left is one row-gather of the RHS per strip.

Applicability is checked at build time: ``from_csr`` fails loudly when
some strip's column span exceeds ``max_width`` (the matrix is not
band-local; use CSR or BlockedELL instead).  Bandwidth-reducing
reorderings (``utils.reorder.rcm``) widen the format's reach.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, register_sparse_pytree

__all__ = ["StripDense"]

_LANES = 128


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class StripDense(SparseFormat):
    strips: jnp.ndarray  # (n_strips, rows_per_strip, width)
    first_col: jnp.ndarray  # (n_strips,) int32 — window origin per strip
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})
    rows_per_strip: int = dataclasses.field(metadata={"static": True})
    width: int = dataclasses.field(metadata={"static": True})

    @property
    def data(self):
        return self.strips

    @property
    def fill_rate(self) -> float:
        return self.nnz / max(self.strips.size, 1)

    @classmethod
    def from_csr(cls, A, rows_per_strip: int = _LANES,
                 max_width: int | None = None) -> "StripDense":
        """Densify each ``rows_per_strip``-row strip at its column window.

        ``max_width`` bounds the stored window (default: 8192 or the
        column count, whichever is smaller); a strip whose nonzeros span
        more raises — StripDense is for band-local structure only.
        """
        sp = A.to_scipy().tocsr()
        if not sp.has_canonical_format:
            # merge duplicates on a copy: to_scipy() may return the
            # container's cached host matrix, which must stay as stored
            sp = sp.copy()
            sp.sum_duplicates()
        rows, cols = sp.shape
        n_strips = max(-(-rows // rows_per_strip), 1)
        cap = min(cols, 8192) if max_width is None else int(max_width)
        r = np.repeat(np.arange(rows), np.diff(sp.indptr))
        s = r // rows_per_strip
        # per-strip column span
        lo = np.full(n_strips, cols, np.int64)
        hi = np.full(n_strips, -1, np.int64)
        np.minimum.at(lo, s, sp.indices)
        np.maximum.at(hi, s, sp.indices)
        span = np.where(hi >= 0, hi - lo + 1, 0)
        if span.max(initial=0) > cap:
            bad = int(span.argmax())
            raise ValueError(
                f"StripDense: strip {bad} spans {int(span[bad])} columns "
                f"(> max_width={cap}); the matrix is not band-local — "
                "use CSR/BlockedELL, or reorder (utils.reorder.rcm) first")
        width = int(min(max(-(-int(span.max(initial=1)) // _LANES), 1)
                        * _LANES, cols))
        first = np.clip(np.where(hi >= 0, lo, 0), 0,
                        max(cols - width, 0)).astype(np.int64)
        strips = np.zeros((n_strips, rows_per_strip, width), sp.dtype)
        strips[s, r % rows_per_strip, sp.indices - first[s]] = sp.data
        return cls(
            strips=jnp.asarray(strips),
            first_col=jnp.asarray(first, jnp.int32),
            shape=(rows, cols),
            nnz=int(sp.nnz),
            rows_per_strip=rows_per_strip,
            width=width,
        )

    def todense(self):
        rows, cols = self.shape
        n_strips = self.strips.shape[0]
        out = jnp.zeros((n_strips * self.rows_per_strip, cols + self.width),
                        self.strips.dtype)
        full = (n_strips, self.rows_per_strip, self.width)
        rid = (jnp.arange(n_strips * self.rows_per_strip)
               .reshape(n_strips, self.rows_per_strip))
        cid = (self.first_col[:, None, None]
               + jnp.arange(self.width)[None, None, :])
        out = out.at[
            jnp.broadcast_to(rid[:, :, None], full),
            jnp.broadcast_to(cid, full),
        ].set(self.strips)
        return out[:rows, :cols]

    def astype(self, dtype):
        return dataclasses.replace(self, strips=self.strips.astype(dtype))
