"""Planned device permutations: a gather plan or a sort plan.

A permutation KNOWN AT PLAN TIME can run as the gather ``x[g]`` or as
``lax.sort_key_val`` keyed by the INVERSE permutation, which delivers the
same ``x[g]``.  ``plan_gather_permutation`` builds both forms; which one
``apply_permutation`` runs is fixed in the plan (``SORT_MIN_ELEMS``, or
``force_sort``).  A general primitive for any planned reorder (CSC→CSR,
partition shuffles).

Reference analogue: none — the reference permutes on the host
(reference src/sparse/sparse-matrix.cc CopyTo).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.base import register_sparse_pytree

__all__ = ["PermutePlan", "plan_gather_permutation", "apply_permutation"]

# plans of at least this many elements default to the sort form; below it
# the gather saves the key-array memory.  Awaiting a sweep on the card.
SORT_MIN_ELEMS = 1 << 14


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class PermutePlan:
    """``out[i] = x[g[i]]`` as a sort: ``sort_key_val(keys, vals)``.

    ``keys`` is the inverse of ``g`` extended to a bijection on
    [0, cap); vals are ``x`` zero-padded to cap.  Slots whose ``g`` was
    a sentinel (or beyond x) read the zero padding.
    """

    keys: jnp.ndarray  # (cap,) int32 — inverse permutation sort keys
    n_out: int = dataclasses.field(metadata={"static": True})
    n_src: int = dataclasses.field(metadata={"static": True})
    use_sort: bool = dataclasses.field(metadata={"static": True})
    gather: jnp.ndarray | None = None  # (n_out,) fallback when not use_sort

    @property
    def cap(self) -> int:
        return self.keys.shape[0]


def plan_gather_permutation(g, n_src: int, n_out: int | None = None,
                            force_sort: bool | None = None) -> PermutePlan:
    """Host-plan ``out[i] = x[g[i]]`` for an INJECTIVE index map ``g``.

    ``g`` entries in [0, n_src) select source elements (each at most
    once — the map must be injective on its real slots); entries
    ≥ n_src are sentinels reading 0.  ``n_out`` defaults to len(g).
    """
    g = np.asarray(g)
    n_out = len(g) if n_out is None else n_out
    g = g[:n_out]
    cap = max(n_out, n_src)
    real = g < n_src
    used = g[real]
    if len(np.unique(used)) != len(used):
        raise ValueError("gather map must be injective on real slots")
    # bijection p on [0, cap): real slots keep their source id; sentinel
    # slots and the extension take the unused ids (those read 0 unless
    # they point below n_src AND x is nonzero there — unused real ids
    # land on slots >= n_out or sentinel slots, both discarded/zeroed)
    p = np.full(cap, -1, np.int64)
    pre = p[:n_out]
    pre[real] = used
    p[:n_out] = pre
    unused = np.setdiff1d(np.arange(cap), used, assume_unique=False)
    # hand the ABOVE-n_src unused ids (zero padding) to sentinel slots
    # first, so the mask pass below is rarely needed at all
    p[p < 0] = unused[::-1]
    keys = np.empty(cap, np.int64)
    keys[p] = np.arange(cap)
    use_sort = cap >= SORT_MIN_ELEMS if force_sort is None else force_sort
    # sentinel slots must read zero padding, not a live x element; when a
    # sentinel slot was keyed onto a live (< n_src) unused id anyway, the
    # apply zeroes it via the mask built here
    mask_needed = bool((p[:n_out][~real] < n_src).any())
    return PermutePlan(
        keys=jnp.asarray(keys, jnp.int32),
        n_out=int(n_out),
        n_src=int(n_src),
        use_sort=bool(use_sort),
        gather=(None if use_sort and not mask_needed
                else jnp.asarray(np.where(real, g, n_src), jnp.int32)),
    )


def apply_permutation(plan, x):
    """Run the planned permutation on device (jittable).

    ``x`` is (n_src,) or longer (extra tail ignored); returns (n_out,).
    2-D ``x`` of shape (n_src, k) is permuted ROW-wise — each moved row
    is one contiguous k-element run, so the row scatter/gather is already
    bandwidth-shaped.
    """
    if x.ndim == 2:
        return _apply_permutation_rows(plan, x)
    if not plan.use_sort:
        xp = jnp.concatenate([x[: plan.n_src],
                              jnp.zeros((1,), x.dtype)])
        return xp[plan.gather]
    vals = jnp.zeros((plan.cap,), x.dtype).at[: plan.n_src].set(
        x[: plan.n_src])
    out = jax.lax.sort_key_val(plan.keys, vals)[1][: plan.n_out]
    if plan.gather is not None:
        # some sentinel slots were keyed onto live source ids — zero them
        out = jnp.where(plan.gather[: plan.n_out] < plan.n_src, out, 0)
    return out


def _apply_permutation_rows(plan, x):
    """Row-wise apply for (n_src, k) inputs (see apply_permutation)."""
    k = x.shape[1]
    if not plan.use_sort:
        xp = jnp.concatenate(
            [x[: plan.n_src], jnp.zeros((1, k), x.dtype)])
        return xp[plan.gather]
    # keys[s] is the destination slot of source s (the sort-plan keys ARE
    # the inverse permutation); live-but-unused sources land on slots
    # ≥ n_out (sliced away) unless the plan recorded a sentinel-slot
    # collision, which the gather mask zeroes exactly as in the 1-D path
    out = (jnp.zeros((plan.cap, k), x.dtype)
           .at[plan.keys[: plan.n_src]].set(x[: plan.n_src]))[: plan.n_out]
    if plan.gather is not None:
        out = jnp.where(
            plan.gather[: plan.n_out, None] < plan.n_src, out, 0)
    return out
