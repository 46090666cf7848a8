"""Sparse triangular solve ``L x = b`` / ``U x = b``.

Design — **level scheduling**: the dependency DAG of the
triangular matrix is stratified on the host into levels whose rows are
mutually independent; the device then runs a ``lax.scan`` over levels, each
step solving its whole level vectorized (gather of already-solved x,
segment-sum of off-diagonal products, divide by diagonal).  Shapes are
static: levels are padded to the max level width with sentinel rows
(the harmless-padding design again).

No reference analogue (SURVEY §7 phase C); verified against scipy
``spsolve_triangular``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR
from ..formats.base import default_index_dtype, register_sparse_pytree

__all__ = [
    "TriSolvePlan", "trisolve_plan", "trisolve_apply", "trisolve",
    "TriFixPlan", "trisolve_fixpoint_plan", "trisolve_fixpoint_apply",
]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    """Level-scheduled triangular structure for a fixed sparsity pattern.

    Per level l and slot s: ``rows[l, s]`` is the row solved there (or n for
    padding).  Off-diagonal entries of each row are padded to ``max_row_nnz``
    with (col=0, a zero value at numeric time).
    """

    rows: jnp.ndarray  # (n_levels, max_width) int32, pad = n
    offdiag_cols: jnp.ndarray  # (n_levels, max_width, max_row_nnz)
    offdiag_vals: jnp.ndarray  # (n_levels, max_width, max_row_nnz)
    diag_vals: jnp.ndarray  # (n_levels, max_width) — pad rows get 1.0
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    lower: bool = dataclasses.field(metadata={"static": True})
    unit_diagonal: bool = dataclasses.field(metadata={"static": True})


def _compute_levels(n: int, dep_rows: np.ndarray,
                    dep_cols: np.ndarray) -> np.ndarray:
    """level(i) = 1 + max level of off-diag deps — Kahn-style peeling, each
    round retires the dependency-free frontier (total work O(nnz))."""
    remaining = np.bincount(dep_rows, minlength=n)
    # reverse adjacency: dependents of column j among off-diag entries
    rev_order = np.argsort(dep_cols, kind="stable")
    rev_rows = dep_rows[rev_order]
    rev_ptr = np.zeros(n + 1, np.int64)
    np.add.at(rev_ptr[1:], dep_cols, 1)
    rev_ptr = np.cumsum(rev_ptr)
    level = np.zeros(n, dtype=np.int64)
    frontier = np.nonzero(remaining == 0)[0]
    remaining[frontier] = -1  # retired
    lvl = 0
    seen = len(frontier)
    while len(frontier):
        level[frontier] = lvl
        # edges leaving the frontier (vectorized multi-range gather)
        lens = rev_ptr[frontier + 1] - rev_ptr[frontier]
        total = int(lens.sum())
        if total:
            starts = np.cumsum(lens) - lens
            idx = (np.arange(total) - np.repeat(starts, lens)
                   + np.repeat(rev_ptr[frontier], lens))
            targets = rev_rows[idx]
            np.subtract.at(remaining, targets, 1)
            cand = np.unique(targets)
            frontier = cand[remaining[cand] == 0]
            remaining[frontier] = -1
        else:
            frontier = np.empty(0, np.int64)
        lvl += 1
        seen += len(frontier)
    if seen < n:
        raise ValueError("trisolve: cyclic structure (matrix not triangular?)")
    return level


def trisolve_plan(A: CSR, lower: bool = True,
                  unit_diagonal: bool = False) -> TriSolvePlan:
    sp = A.to_scipy().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("trisolve needs a square matrix")
    indptr, indices, data = sp.indptr.astype(np.int64), sp.indices, sp.data

    # classify entries (vectorized): row id per entry, off-diag mask
    rid = np.repeat(np.arange(n), np.diff(indptr))
    offd = (indices < rid) if lower else (indices > rid)
    diag_mask = indices == rid

    level = _compute_levels(n, rid[offd], indices[offd].astype(np.int64))
    n_levels = int(level.max()) + 1 if n else 1

    widths = np.bincount(level, minlength=n_levels) if n else np.array([0])
    max_width = max(int(widths.max()) if n else 0, 1)
    od_counts = np.bincount(rid[offd], minlength=n)
    max_row_nnz = max(int(od_counts.max()) if n else 0, 1)

    # slot of each row within its level (stable order by row id)
    order_r = np.lexsort((np.arange(n), level))
    slot = np.empty(n, np.int64)
    lvl_start = np.cumsum(np.concatenate([[0], widths]))[:-1]
    slot[order_r] = np.arange(n) - lvl_start[level[order_r]]

    rows = np.full((n_levels, max_width), n, dtype=np.int64)
    rows[level, slot] = np.arange(n)
    od_cols = np.zeros((n_levels, max_width, max_row_nnz), dtype=np.int64)
    od_vals = np.zeros((n_levels, max_width, max_row_nnz), dtype=data.dtype)
    dvals = np.ones((n_levels, max_width), dtype=data.dtype)
    # scatter off-diag entries: kk = within-row off-diag rank
    csum = np.cumsum(offd)
    row_base = np.concatenate([[0], csum])[indptr[:-1]]
    kk = (csum - 1 - np.repeat(row_base, np.diff(indptr)))[offd]
    er = rid[offd]
    od_cols[level[er], slot[er], kk] = indices[offd]
    od_vals[level[er], slot[er], kk] = data[offd]
    if not unit_diagonal:
        drows = rid[diag_mask]
        if len(drows) < n or (data[diag_mask] == 0).any():
            missing = np.setdiff1d(np.arange(n), drows)
            bad = (missing[0] if len(missing)
                   else drows[np.nonzero(data[diag_mask] == 0)[0][0]])
            raise ValueError(f"zero/missing diagonal at row {bad}")
        dvals[level[drows], slot[drows]] = data[diag_mask]

    idt = default_index_dtype
    return TriSolvePlan(
        rows=jnp.asarray(rows, idt),
        offdiag_cols=jnp.asarray(od_cols, idt),
        offdiag_vals=jnp.asarray(od_vals),
        diag_vals=jnp.asarray(dvals),
        shape=(n, n),
        lower=lower,
        unit_diagonal=unit_diagonal,
    )


def trisolve_apply(plan: TriSolvePlan, b):
    """Device numeric solve (jittable): scan over levels."""
    n = plan.shape[0]
    x0 = jnp.zeros((n + 1,), b.dtype)  # slot n = padding target
    bp = jnp.concatenate([b, jnp.zeros((1,), b.dtype)])

    def step(x, lvl):
        rows, od_cols, od_vals, dvals = lvl
        # gather solved x at dependency columns: (width, max_row_nnz)
        contrib = jnp.sum(od_vals * x[od_cols], axis=1)
        xi = (bp[rows] - contrib) / dvals
        x = x.at[rows].set(xi)  # padding rows write slot n
        return x, None

    x, _ = jax.lax.scan(
        step, x0, (plan.rows, plan.offdiag_cols, plan.offdiag_vals,
                   plan.diag_vals)
    )
    return x[:n]


def trisolve(A: CSR, b, lower: bool = True, unit_diagonal: bool = False):
    """One-shot triangular solve (host plan + device apply).

    ``b`` is a vector (n,) or a panel (n, k); a panel solves its columns
    through one vmapped level scan.
    """
    plan = trisolve_plan(A, lower=lower, unit_diagonal=unit_diagonal)
    if jnp.ndim(b) == 2:
        return jax.vmap(lambda c: trisolve_apply(plan, c),
                        in_axes=1, out_axes=1)(b)
    return trisolve_apply(plan, b)


# ---------------------------------------------------------------------------
# Fixed-point (Jacobi/Neumann) triangular solve — the SpMV formulation
# ---------------------------------------------------------------------------

@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class TriFixPlan:
    """Triangular solve as a nilpotent fixed-point iteration.

    With ``A = D + E`` (D diagonal, E strictly triangular), the Jacobi
    update ``x ← D⁻¹(b − E x)`` started from ``x₀ = D⁻¹ b`` satisfies
    ``x_k = Σ_{j≤k} (−D⁻¹E)^j D⁻¹ b`` — and ``(D⁻¹E)^m = 0`` where m is
    the level count of the dependency DAG, so ``n_iters = m − 1`` updates
    give the EXACT solve.  Each update is one CSR SpMV of E inside
    ``lax.scan`` (total work ``n_iters · nnz(E)`` against the level scan's
    ``nnz``, but every step is one wide gather + segment-sum).
    ``n_iters`` can be lowered for an approximate solve (preconditioner
    use).
    """

    e: CSR  # strictly-triangular E
    inv_diag: jnp.ndarray  # (n,) — 1/diag (ones for unit_diagonal)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_iters: int = dataclasses.field(metadata={"static": True})
    lower: bool = dataclasses.field(metadata={"static": True})
    unit_diagonal: bool = dataclasses.field(metadata={"static": True})


def trisolve_fixpoint_plan(A: CSR, lower: bool = True,
                           unit_diagonal: bool = False,
                           n_iters: int | None = None,
                           capacity: int | None = None) -> TriFixPlan:
    """Build the fixed-point plan: split off E, invert D, count levels.

    ``n_iters=None`` → exact (levels − 1 updates); a smaller value gives
    the truncated-Neumann approximate solve (still a fixed linear
    operator — valid as a preconditioner).  ``capacity`` pads E with
    explicit zeros to that many stored entries.
    """
    import scipy.sparse as sps

    sp = A.to_scipy().tocsr()
    sp.sort_indices()
    n = sp.shape[0]
    if sp.shape[0] != sp.shape[1]:
        raise ValueError("trisolve needs a square matrix")
    indptr, indices, data = sp.indptr.astype(np.int64), sp.indices, sp.data
    rid = np.repeat(np.arange(n), np.diff(indptr))
    offd = (indices < rid) if lower else (indices > rid)
    diag_mask = indices == rid

    inv_d = np.ones(n, dtype=data.dtype)
    if not unit_diagonal:
        drows = rid[diag_mask]
        dv = data[diag_mask]
        if len(drows) < n or (dv == 0).any():
            missing = np.setdiff1d(np.arange(n), drows)
            bad = (missing[0] if len(missing)
                   else drows[np.nonzero(dv == 0)[0][0]])
            raise ValueError(f"zero/missing diagonal at row {bad}")
        inv_d[drows] = 1.0 / dv

    if n_iters is None:
        level = _compute_levels(n, rid[offd], indices[offd].astype(np.int64))
        n_iters = max(int(level.max()) if n else 0, 0)

    E = sps.coo_matrix(
        (data[offd], (rid[offd], indices[offd])), shape=(n, n)
    ).tocsr()
    E.sort_indices()
    e_ptr, e_idx, e_val = E.indptr.astype(np.int64), E.indices, E.data
    if capacity is not None:
        pad = capacity - E.nnz
        if pad < 0:
            raise ValueError(f"capacity {capacity} < nnz(E) = {E.nnz}")
        # explicit zeros in the last row make nnz == capacity, so plans
        # built with one capacity share one static layout
        e_ptr = e_ptr.copy()
        e_ptr[-1] += pad
        e_idx = np.concatenate([e_idx, np.zeros(pad, e_idx.dtype)])
        e_val = np.concatenate([e_val, np.zeros(pad, e_val.dtype)])
    return TriFixPlan(
        e=CSR.from_arrays(e_ptr, e_idx, e_val, (n, n)),
        inv_diag=jnp.asarray(inv_d),
        shape=(n, n),
        n_iters=int(n_iters),
        lower=lower,
        unit_diagonal=unit_diagonal,
    )


def trisolve_fixpoint_apply(plan: TriFixPlan, b):
    """Device numeric solve (jittable): ``n_iters`` CSR SpMVs."""
    from .spmv import spmv

    x = plan.inv_diag * b

    def step(x, _):
        x = plan.inv_diag * (b - spmv(plan.e, x))
        return x, None

    if plan.n_iters:
        x, _ = jax.lax.scan(step, x, None, length=plan.n_iters)
    return x
