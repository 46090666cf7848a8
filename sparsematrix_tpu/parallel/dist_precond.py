"""Per-shard block preconditioning for the distributed Krylov solvers.

Block-Jacobi with *real* incomplete factorizations: each shard owns the
IC(0)/ILU(0) factors of its local diagonal block ``A_ii`` and applies
their triangular solves (level scan, or truncated fixed point) to its
residual band — no collectives, the classic distributed block
preconditioner.

Plans are built on the host per shard, padded to one static layout, and
their array leaves stacked along a leading shard axis; the
solvers shard that state pytree over the mesh axis so each device slices
out exactly its own factors (``ShardedPrecond`` protocol, handled by
``dist_cg``/``dist_bicgstab``/``dist_gmres``).

No reference counterpart (the reference is single-node with no solver
layer, SURVEY §2.4) — this is north-star composition: partition once,
factor locally, iterate globally.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSR
from ..ops.trisolve import TriSolvePlan

__all__ = ["ShardedPrecond", "block_ic0_precond", "block_ilu0_precond"]


@dataclasses.dataclass(frozen=True)
class ShardedPrecond:
    """A preconditioner whose state is sharded over the solve mesh.

    ``state``: pytree whose array leaves are stacked (n_shards, ...);
    the dist solvers pass it through shard_map with P(axis) on the
    leading axis.  ``fn(r_local, state_local) -> z_local`` sees leaves
    sliced to (1, ...).
    """

    state: Any
    fn: Callable


def _local_block(sp, r0, lr, n):
    import scipy.sparse as sps

    real = min(n - r0, lr)
    blk = sp[r0:r0 + real, r0:r0 + real].tocoo()
    if real == lr:
        return blk.tocsr()
    # padding rows on the last shard: unit diagonal keeps factors exact
    pad = np.arange(real, lr)
    r = np.concatenate([blk.row, pad])
    c = np.concatenate([blk.col, pad])
    v = np.concatenate([blk.data, np.ones(lr - real, blk.data.dtype)])
    return sps.coo_matrix((v, (r, c)), shape=(lr, lr)).tocsr()


def _pad_level_plan(p: TriSolvePlan, n_levels, width, row_nnz):
    """Pad a level plan with empty levels, slots and off-diagonal entries
    (padding rows write the spare slot n with unit diagonal; zero-valued
    off-diagonals gather x[0] and contribute nothing)."""
    n = p.shape[0]
    L, W, R = p.offdiag_cols.shape
    pad2 = ((0, n_levels - L), (0, width - W))
    pad3 = pad2 + ((0, row_nnz - R),)
    return dataclasses.replace(
        p,
        rows=jnp.pad(p.rows, pad2, constant_values=n),
        offdiag_cols=jnp.pad(p.offdiag_cols, pad3),
        offdiag_vals=jnp.pad(p.offdiag_vals, pad3),
        diag_vals=jnp.pad(p.diag_vals, pad2, constant_values=1),
    )


def _level_plans(blocks, build):
    plans = [build(blk) for blk in blocks]
    dims = np.max([[t.offdiag_cols.shape for t in pair] for pair in plans],
                  axis=0)  # per triangle (levels, width, row_nnz)
    return [tuple(_pad_level_plan(t, *d) for t, d in zip(pair, dims))
            for pair in plans]


def _fixpoint_plans(blocks, build, n_iters):
    """Fixed-point plans with one iteration count and one E capacity, so
    every shard's plan has the same static layout."""
    plans = [build(blk, n_iters=n_iters) for blk in blocks]
    cap = max(t.e.nnz for pair in plans for t in pair)
    iters = max(t.n_iters for pair in plans for t in pair)
    return [build(blk, n_iters=iters, capacity=cap) for blk in blocks]


def _stack_plans(plans):
    treedefs = {jax.tree_util.tree_structure(p) for p in plans}
    if len(treedefs) != 1:
        raise ValueError(
            "per-shard plans disagree on static layout — equal local-block "
            "structure is required to stack them")
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *plans)


def _block_factor_precond(A: CSR, n_shards: int, factor: str,
                          engine: str, n_iters: int | None
                          ) -> ShardedPrecond:
    from ..ops import ichol, ilu

    sp = A.to_scipy().tocsr()
    n = sp.shape[0]
    lr = -(-n // n_shards)
    blocks = [CSR.from_scipy(_local_block(sp, s * lr, lr, n))
              for s in range(n_shards)]
    if engine == "level":
        build = ichol.ic0_plans if factor == "ic0" else ilu.ilu0_plans
        plans = _level_plans(blocks, build)
    elif engine == "fixpoint":
        build = (ichol.ic0_fixpoint_plans if factor == "ic0"
                 else ilu.ilu0_fixpoint_plans)
        plans = _fixpoint_plans(blocks, build, n_iters)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    state = _stack_plans(plans)

    def fn(r_local, state_local):
        local = jax.tree_util.tree_map(lambda x: x[0], state_local)
        return ilu.ilu_apply(local, r_local)

    return ShardedPrecond(state=state, fn=fn)


def block_ic0_precond(A: CSR, n_shards: int, engine: str = "level",
                      n_iters: int | None = None) -> ShardedPrecond:
    """IC(0) of each shard's diagonal block, solved per apply.

    ``engine``: "level" (exact level-scheduled solves) or "fixpoint"
    (fixed-point SpMV solves; ``n_iters`` truncates them into an
    approximate preconditioner, ``None`` keeps them exact).
    """
    return _block_factor_precond(A, n_shards, "ic0", engine, n_iters)


def block_ilu0_precond(A: CSR, n_shards: int, engine: str = "level",
                       n_iters: int | None = None) -> ShardedPrecond:
    """ILU(0) of each shard's diagonal block (nonsymmetric systems)."""
    return _block_factor_precond(A, n_shards, "ilu0", engine, n_iters)
