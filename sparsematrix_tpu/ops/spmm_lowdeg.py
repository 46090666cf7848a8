"""Sliced-ELL row-gather SpMM — a low-degree multi-RHS layout.

At ≲8 entries/row the direct row-gather formulation

    y[r] = Σ_j vals[r, j] · X[cols[r, j], :]

moves each gathered X row as one contiguous k-element run.  Plain ELL
pays for width padding (Poisson(2) degrees pad to width ~11), so rows
are DEGREE-SORTED and split into segments whose widths track their own
max degree (SELL-C-σ with σ = all rows, segment boundaries where padding
would exceed ~1/3); one einsum per segment, and the output is restored
by a contiguous ROW gather — the same cheap op the layout is built on.

No reference analogue (the reference is single-format).  An explicit
pack: ``spmm`` runs a ``SlicedEllMM`` it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..formats import CSR
from ..formats.base import register_sparse_pytree
from ..utils.precision import matmul_precision

__all__ = ["SlicedEllMM", "pack_sliced_ell", "spmm_sliced_ell"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class SlicedEllMM:
    vals: tuple  # per segment: (nb, w) fp32 (zero padding)
    cols: tuple  # per segment: (nb, w) int32 (sentinel = cols → zero row)
    out_rows: jnp.ndarray  # (rows,) int32: sorted-slot index per row
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def fill_rate(self) -> float:
        pad = sum(int(v.size) for v in self.vals)
        return self.nnz / max(pad, 1)


def pack_sliced_ell(A: CSR, max_waste: float = 0.33,
                    max_segments: int = 8) -> SlicedEllMM:
    """Degree-sort rows and cut segments where a single width would
    waste more than ``max_waste`` of its cells."""
    sp = A.to_scipy().tocsr()
    sp.sum_duplicates()
    rows, cols = sp.shape
    deg = np.diff(sp.indptr)
    order = np.argsort(-deg, kind="stable")
    sdeg = deg[order]
    # segment cuts: width = segment's first (max) degree; close the
    # segment when mean/width drops under 1 - max_waste, respecting the
    # segment budget (the tail segment takes whatever remains)
    cuts = [0]
    i = 0
    while i < rows and len(cuts) <= max_segments:
        w = max(int(sdeg[i]), 1)
        j = i
        acc = 0
        while j < rows:
            nxt = acc + int(sdeg[j])
            if (j - i + 1) * w * (1 - max_waste) > nxt \
                    and len(cuts) < max_segments:
                break
            acc = nxt
            j += 1
        cuts.append(j)
        i = j
    if cuts[-1] < rows:
        cuts.append(rows)
    vals_b, cols_b = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        seg_rows = order[a:b]
        w = max(int(sdeg[a]) if a < rows else 1, 1)
        nb = b - a
        v = np.zeros((nb, w), np.float32)
        c = np.full((nb, w), cols, np.int64)
        lo = sp.indptr[seg_rows]
        ln = deg[seg_rows]
        t_ix = np.repeat(np.arange(nb), ln)
        j_ix = np.arange(int(ln.sum())) - np.repeat(
            np.cumsum(ln) - ln, ln)
        src_ix = np.repeat(lo, ln) + j_ix
        v[t_ix, j_ix] = sp.data[src_ix]
        c[t_ix, j_ix] = sp.indices[src_ix]
        vals_b.append(jnp.asarray(v))
        cols_b.append(jnp.asarray(c, jnp.int32))
    g = np.empty(rows, np.int64)
    g[order] = np.arange(rows)
    return SlicedEllMM(
        vals=tuple(vals_b), cols=tuple(cols_b),
        out_rows=jnp.asarray(g, jnp.int32),
        shape=(rows, cols), nnz=int(sp.nnz))


def spmm_sliced_ell(packed: SlicedEllMM, X):
    """``Y = A @ X`` (jittable, differentiable — XLA row gathers +
    einsums; the un-permute is itself a contiguous row gather, the same
    cheap op the layout is built on)."""
    rows, cols = packed.shape
    k = X.shape[1]
    Xp = jnp.concatenate([X, jnp.zeros((1, k), X.dtype)])  # sentinel row
    parts = []
    for v, c in zip(packed.vals, packed.cols):
        gathered = Xp[c]  # (nb, w, k) — contiguous k-float row runs
        parts.append(jnp.einsum("rw,rwk->rk", v, gathered,
                                precision=matmul_precision(v.dtype)))
    y_sorted = jnp.concatenate(parts, axis=0)  # (rows, k) in degree order
    return y_sorted[packed.out_rows]
