"""SpGEMM: ``C = A @ B`` with both operands sparse.

Design — **symbolic / numeric split** (the sparse-library
classic, adapted to XLA's static-shape rule): the output structure and the
multiply "program" are computed once on the host (symbolic phase); the
numeric phase is a pure, jittable gather-multiply-segment_sum over static
shapes, reusable for any values with the same sparsity pattern
(encode-once / multiply-many — the same design stance as the reference's
``CopyForm``-then-``AddMatMat`` split, sparse-matrix.cc:21,140).

The symbolic phase enumerates all (a_entry, b_entry) contraction pairs
(k-matches) and the output slot each pair accumulates into:

    C.data[slot] = Σ_{pairs p: target(p)=slot} A.data[pa[p]] * B.data[pb[p]]

No reference analogue exists (SURVEY §7 phase C) — verified against scipy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR
from ..formats.base import default_index_dtype, register_sparse_pytree
from ..utils.precision import matmul_precision

__all__ = ["SpGEMMPlan", "spgemm_plan", "spgemm_apply", "spgemm",
           "spgemm_densify", "spgemm_extract"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Precomputed multiply program for a fixed (A, B) sparsity pattern."""

    pa: jnp.ndarray  # (n_pairs_cap,) index into A.data
    pb: jnp.ndarray  # (n_pairs_cap,) index into B.data
    target: jnp.ndarray  # (n_pairs_cap,) index into C.data (out-of-range pad)
    c_indptr: jnp.ndarray  # (m+1,)
    c_indices: jnp.ndarray  # (c_nnz_cap,)
    c_row_ids: jnp.ndarray  # (c_nnz_cap,)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_pairs: int = dataclasses.field(metadata={"static": True})
    c_nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def nnz(self) -> int:
        return self.c_nnz


def spgemm_plan(A: CSR, B: CSR, pair_capacity: int | None = None,
                c_capacity: int | None = None) -> SpGEMMPlan:
    """Symbolic phase (host).  O(flops) enumeration via scipy structure."""
    sa = A.to_scipy().tocsr()
    sb = B.to_scipy().tocsr()
    m, ka = sa.shape
    kb, n = sb.shape
    if ka != kb:
        raise ValueError(f"spgemm: inner dims {ka} != {kb}")

    import scipy.sparse as sps

    sa.sort_indices()
    sb.sort_indices()
    # output structure from the STRUCTURAL boolean product (indicator data:
    # explicitly-stored zeros are stored slots)
    ind = lambda s: sps.csr_matrix(
        (np.ones(len(s.indices), np.int8), s.indices, s.indptr), shape=s.shape
    )
    pattern = (ind(sa) @ ind(sb)).tocsr()
    pattern.sort_indices()
    c_nnz = int(pattern.nnz)

    # vectorized pair enumeration: A entry ai (row i, col k) pairs with the
    # whole B row k
    b_indptr, b_indices = sb.indptr.astype(np.int64), sb.indices
    c_indptr, c_indices = pattern.indptr, pattern.indices
    a_nnz = len(sa.indices)
    a_rows = np.repeat(np.arange(m), np.diff(sa.indptr))
    ka = sa.indices.astype(np.int64)
    cnt = (b_indptr[ka + 1] - b_indptr[ka])  # B-row length per A entry
    n_pairs = int(cnt.sum())
    pa_v = np.repeat(np.arange(a_nnz), cnt)
    # offset of each pair within its A-entry's B row
    starts = np.cumsum(cnt) - cnt
    off = np.arange(n_pairs) - np.repeat(starts, cnt)
    pb_v = b_indptr[ka[pa_v]] + off
    # target slot: row-major+col-sorted C keys are globally sorted
    c_rows = np.repeat(np.arange(m), np.diff(c_indptr))
    key_c = c_rows.astype(np.int64) * n + c_indices.astype(np.int64)
    key_p = (a_rows[pa_v].astype(np.int64) * n
             + b_indices[pb_v].astype(np.int64))
    tgt_v = np.searchsorted(key_c, key_p)

    pcap = max(n_pairs, 1) if pair_capacity is None else int(pair_capacity)
    ccap = max(c_nnz, 1) if c_capacity is None else int(c_capacity)

    pa = np.zeros(pcap, dtype=np.int64)
    pb = np.zeros(pcap, dtype=np.int64)
    tgt = np.full(pcap, ccap, dtype=np.int64)  # pad targets out of range
    pa[:n_pairs] = pa_v
    pb[:n_pairs] = pb_v
    tgt[:n_pairs] = tgt_v

    ci = np.zeros(ccap, dtype=np.int64)
    ci[:c_nnz] = c_indices
    crow = np.full(ccap, m, dtype=np.int64)
    crow[:c_nnz] = np.repeat(np.arange(m), np.diff(c_indptr))

    idt = default_index_dtype
    return SpGEMMPlan(
        pa=jnp.asarray(pa, idt),
        pb=jnp.asarray(pb, idt),
        target=jnp.asarray(tgt, idt),
        c_indptr=jnp.asarray(c_indptr, idt),
        c_indices=jnp.asarray(ci, idt),
        c_row_ids=jnp.asarray(crow, idt),
        shape=(m, n),
        n_pairs=n_pairs,
        c_nnz=c_nnz,
    )


def spgemm_apply(plan: SpGEMMPlan, a_data, b_data) -> CSR:
    """Numeric phase (device, jittable): gather-multiply-segment_sum."""
    prod = a_data[plan.pa] * b_data[plan.pb]
    # padding pairs gather real values but scatter to the drop slot
    c_data = jax.ops.segment_sum(prod, plan.target,
                                 num_segments=plan.c_indices.shape[0] + 1)[:-1]
    return CSR(
        indptr=plan.c_indptr,
        indices=plan.c_indices,
        data=c_data,
        row_ids=plan.c_row_ids,
        shape=plan.shape,
        nnz=plan.c_nnz,
    )


# density-adaptive SpGEMM routing constants: the modelled throughput of
# the dense densify+product+extract path (FLOP/s) against the pair
# program (pairs/s).  Awaiting a sweep on the card.
_DENSE_FLOPS_PER_S = 23e12
_PAIRS_PER_S = 0.4e9
_DENSIFY_MAX_DENSE_ELEMS = 512 * 1024 * 1024  # 2 GB fp32 product cap


def _estimate_pairs(A: CSR, B: CSR) -> int:
    """Exact pair count Σ_k deg_A-col(k)·deg_B-row(k) from host arrays."""
    ba = np.asarray(B.indptr)
    brow = np.diff(ba)
    acol = np.bincount(np.asarray(A.indices)[: A.nnz],
                       minlength=B.shape[0])
    return int((acol[: len(brow)] * brow).sum())


def spgemm(A: CSR, B: CSR, method: str = "auto",
           output: str = "csr") -> CSR:
    """One-shot SpGEMM (symbolic on host + numeric on device).

    method: "auto" (density-adaptive: the dense product when its modelled
    time beats the pair program's), "sparse" (pair program only), or
    "densify" (force the dense product + extract).

    output: "csr" (C as CSR) or "csc" (C^T as CSR — the reference's
    ``CopyTo(trans)`` convention, sparse-matrix.cc:124), computed as
    ``Bᵀ @ Aᵀ`` so the result comes out in CSR order of C^T directly.
    """
    if method not in ("auto", "sparse", "densify"):
        raise ValueError(f"unknown method {method!r}")
    if output not in ("csr", "csc"):
        raise ValueError(f"unknown output {output!r}")
    if output == "csc":
        return spgemm(B.transpose(), A.transpose(), method=method)
    m, k = A.shape
    _, n = B.shape
    if method != "sparse":
        dense_ok = (m * n <= _DENSIFY_MAX_DENSE_ELEMS
                    and m * k <= _DENSIFY_MAX_DENSE_ELEMS
                    and k * n <= _DENSIFY_MAX_DENSE_ELEMS)
        pick_dense = method == "densify"
        if method == "auto" and dense_ok:
            t_dense = 2.0 * m * k * n / _DENSE_FLOPS_PER_S
            t_sparse = _estimate_pairs(A, B) / _PAIRS_PER_S
            pick_dense = t_dense < t_sparse
        if pick_dense and dense_ok:
            plan = spgemm_plan(A, B)
            return spgemm_extract(plan, spgemm_densify(A, B))
    plan = spgemm_plan(A, B)
    return spgemm_apply(plan, A.data, B.data)


def spgemm_densify(A, B):
    """``C = A @ B`` via densified operands and one dense product
    (jittable).

    The density-adaptive regime for SpGEMM: every gather-based pair
    program moves several bytes per multiply-add through gathers and a
    scatter, while the dense product runs at matmul rate — so above a
    density-dependent crossover the "wasteful" dense matmul wins outright.
    Same stance as the reference's dense-vs-sparse race
    (blas_test.cc:41) and this framework's densify SpMM path.  Returns a
    ``Dense`` container (extract a sparse pattern with
    ``spgemm_extract``).
    """
    from ..formats import Dense

    ad = A.todense() if not isinstance(A, Dense) else A.data
    bd = B.todense() if not isinstance(B, Dense) else B.data
    cd = jnp.dot(ad, bd, precision=matmul_precision(ad.dtype))
    return Dense(data=cd, shape=(ad.shape[0], bd.shape[1]),
                 nnz=cd.shape[0] * cd.shape[1])


def spgemm_extract(plan: SpGEMMPlan, dense) -> CSR:
    """Gather a dense product down to the plan's C pattern (jittable).

    One 2-D gather per stored slot — only worth it when a sparse C
    container is required downstream; otherwise keep the Dense.
    """
    from ..formats import Dense

    cd = dense.data if isinstance(dense, Dense) else dense
    m, n = plan.shape
    rid = jnp.minimum(plan.c_row_ids, m - 1)
    data = cd[rid, plan.c_indices]
    # padding slots (row_ids == m) carry zero
    data = jnp.where(plan.c_row_ids < m, data, 0)
    return CSR(
        indptr=plan.c_indptr,
        indices=plan.c_indices,
        data=data,
        row_ids=plan.c_row_ids,
        shape=plan.shape,
        nnz=plan.c_nnz,
    )
