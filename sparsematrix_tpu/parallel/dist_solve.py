"""Distributed Krylov solve: CG over a row-partitioned CSR on a device mesh.

The reference has no solver or distributed layer (SURVEY §2.4); this is the
north-star composition: the WHOLE iteration lives inside one ``shard_map``
region, so per iteration the only communication is

  * one tiled ``all_gather`` of the search direction (the x-halo exchange), and
  * two scalar ``psum``s: one for ``p·Ap`` and ONE stacked psum carrying
    both ``r·z`` and ``r·r`` (the convergence test reuses the carried
    ``r·r`` — no extra collective in ``cond``).

State (x, r, p, z) stays sharded by row band the entire solve — nothing
device-global ever materializes except the gathered direction vector, and
XLA overlaps the gather with the local SpMV's leading gathers.

Preconditioning is local-by-construction (block-diagonal): ``precond=
"jacobi"`` builds the inverse diagonal from the local band on device; a
callable receives the *local* residual band and must return a local band
(no collectives required — the classic distributed block preconditioner).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..solvers.krylov import _TRUE_RESIDUAL_RESTARTS, SolveResult
from .dist_ops import _pad_vec
from .partition import PartitionedCSR

__all__ = ["dist_cg", "dist_bicgstab", "dist_gmres"]


def _local_diag_inv(ip, ix, dd, rid, local_rows, row0):
    """Inverse diagonal of the local row band (Jacobi), on device.

    A stored entry is diagonal iff its global column equals its global row
    (row partitioning keeps global column ids).  Padding entries carry
    ``rid == local_rows`` and are dropped by segment_sum's bounds.
    """
    is_diag = ix == (rid + row0)
    diag = jax.ops.segment_sum(
        jnp.where(is_diag, dd, 0.0), rid, num_segments=local_rows)
    safe = jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)
    return jnp.where(jnp.abs(diag) > 1e-30, 1.0 / safe, 1.0)


def _local_env(part, p_local, precond, axis_name, m_local=None):
    """Per-shard matvec + preconditioner closures (shared by every dist
    solver).  ``p_local`` is the PartitionedCSR slice seen inside shard_map
    (leading dim 1); ``m_local`` is a ShardedPrecond's state slice."""
    from .dist_precond import ShardedPrecond

    ip, ix, dd, rid = part.local_csr_arrays(p_local)
    cols = part.shape[1]
    row0 = jax.lax.axis_index(axis_name) * part.local_rows

    if precond == "jacobi":
        dinv = _local_diag_inv(ip, ix, dd, rid, part.local_rows, row0)
        apply_M = lambda r: r * dinv
    elif isinstance(precond, ShardedPrecond):
        apply_M = lambda r: precond.fn(r, m_local)
    elif callable(precond):
        apply_M = lambda r: precond(r, jax.lax.axis_index(axis_name))
    else:
        apply_M = lambda r: r

    def matvec(v_local):
        v_full = jax.lax.all_gather(v_local, axis_name, tiled=True)
        prod = dd * v_full[:cols][ix]
        return jax.ops.segment_sum(prod, rid, num_segments=part.local_rows)

    return matvec, apply_M


def _precond_state(precond, n_shards):
    """The shard_map operand carrying a ShardedPrecond's stacked state
    (a tiny dummy when the preconditioner has none)."""
    from .dist_precond import ShardedPrecond

    if isinstance(precond, ShardedPrecond):
        return precond.state
    return jnp.zeros((n_shards,), jnp.float32)


def _check_square_rows(part, name):
    if part.partition_axis != "rows":
        raise ValueError(f"{name} requires a row-partitioned matrix")
    rows, cols = part.shape
    if rows != cols:
        raise ValueError(f"{name} requires a square matrix, got {part.shape}")


def dist_cg(part: PartitionedCSR, b, mesh: Mesh, axis_name: str = "shard",
            precond: Union[None, str, Callable] = None,
            x0=None, tol: float = 1e-6, maxiter: int = 1000) -> SolveResult:
    """Conjugate gradients for SPD ``A`` row-partitioned over ``mesh``.

    Args:
      part: row-partitioned matrix (``partition_csr_rows``), sharded over
        ``mesh`` (see ``shard_partitioned``).
      b: global RHS (length = rows); padded & sharded internally.
      precond: ``None``, ``"jacobi"`` (local inverse diagonal), or a
        callable ``(r_local, shard_index) -> z_local`` applied per band.
      x0: optional global initial guess.
    Returns:
      SolveResult with the GLOBAL solution vector (sharded output,
      reassembled to length rows).
    """
    _check_square_rows(part, "dist_cg")
    rows, cols = part.shape
    n = part.n_shards
    pad_len = n * part.local_rows
    b_pad = _pad_vec(b, pad_len)
    x0_pad = _pad_vec(x0, pad_len) if x0 is not None else jnp.zeros_like(b_pad)

    def _psum_dot(a, c):
        return jax.lax.psum(jnp.vdot(a, c), axis_name)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(), P()),
        # a ShardedPrecond state is per-shard by construction
        check_vma=False,
    )
    def run(p_local, b_local, x_local, m_local):
        matvec, apply_M = _local_env(part, p_local, precond, axis_name,
                                     m_local)
        b_loc = b_local
        x_loc = x_local

        def _dots2(a, c, d, e):
            # both global dots in ONE collective (stacked scalar psum)
            return jax.lax.psum(
                jnp.stack([jnp.vdot(a, c), jnp.vdot(d, e)]), axis_name)

        bnorm = jnp.sqrt(jnp.maximum(_psum_dot(b_loc, b_loc), 1e-60))

        def cond(state):
            x, r, p, rz, rr, k = state
            return jnp.logical_and(k < maxiter,
                                   jnp.sqrt(jnp.maximum(rr, 0.0)) / bnorm
                                   > tol)

        def body(state):
            x, r, p, rz, rr, k = state
            Ap = matvec(p)
            alpha = rz / jnp.maximum(_psum_dot(p, Ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = apply_M(r)
            rz_new, rr_new = _dots2(r, z, r, r)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return (x, r, p, rz_new, rr_new, k + 1)

        # restart from the true residual once the recurrence converges
        # (solvers.krylov._TRUE_RESIDUAL_RESTARTS)
        k = 0
        for _ in range(1 + _TRUE_RESIDUAL_RESTARTS):
            r = b_loc - matvec(x_loc)
            z = apply_M(r)
            rz, rr = _dots2(r, z, r, r)
            x_loc, r, p, rz, rr, k = jax.lax.while_loop(
                cond, body, (x_loc, r, z, rz, rr, k))
        return x_loc, k, jnp.sqrt(jnp.maximum(rr, 0.0))

    x, iters, residual = run(part, b_pad, x0_pad,
                             _precond_state(precond, part.n_shards))
    return SolveResult(x=x.reshape(-1)[:rows], iters=iters,
                       residual=residual)


def dist_bicgstab(part: PartitionedCSR, b, mesh: Mesh,
                  axis_name: str = "shard",
                  precond: Union[None, str, Callable] = None,
                  x0=None, tol: float = 1e-6,
                  maxiter: int = 1000) -> SolveResult:
    """BiCGSTAB for general (nonsymmetric) row-partitioned ``A``.

    Same communication structure as :func:`dist_cg` — two all_gathered
    matvecs per iteration plus four scalar psums (``rho``; ``rhat·v``; a
    stacked one carrying ``t·t``/``t·s``; and the recomputed ``r·r``,
    which replaces the cancellation-prone recurrence norm).
    Preconditioning is applied right (``A M⁻¹``), so the residual is the
    TRUE residual.  On ``rho`` or ``t·t`` collapsing to ~0 the solver
    stops and sets ``SolveResult.breakdown``.
    """
    _check_square_rows(part, "dist_bicgstab")
    rows, _ = part.shape
    pad_len = part.n_shards * part.local_rows
    b_pad = _pad_vec(b, pad_len)
    x0_pad = _pad_vec(x0, pad_len) if x0 is not None else jnp.zeros_like(b_pad)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(), P(), P()),
        # a ShardedPrecond state is per-shard by construction
        check_vma=False,
    )
    def run(p_local, b_loc, x_loc, m_local):
        matvec, apply_M = _local_env(part, p_local, precond, axis_name,
                                     m_local)

        def psum_dot(a, c):
            return jax.lax.psum(jnp.vdot(a, c), axis_name)

        r = b_loc - matvec(x_loc)
        rhat = r
        rr = psum_dot(r, r)
        one = jnp.asarray(1.0, b_loc.dtype)
        bnorm = jnp.sqrt(jnp.maximum(psum_dot(b_loc, b_loc), 1e-60))

        def cond(state):
            *_, rr, bad, k = state
            keep = jnp.logical_and(k < maxiter,
                                   jnp.sqrt(jnp.maximum(rr, 0.0)) / bnorm
                                   > tol)
            return jnp.logical_and(keep, jnp.logical_not(bad))

        eps_bd = jnp.finfo(b_loc.dtype).tiny * 1e3

        def body(state):
            x, r, rho, alpha, omega, v, p, rr, bad, k = state
            rho_new = psum_dot(rhat, r)
            beta = (rho_new / jnp.where(rho == 0, 1e-30, rho)) * (
                alpha / jnp.where(omega == 0, 1e-30, omega))
            p = r + beta * (p - omega * v)
            phat = apply_M(p)
            v = matvec(phat)
            rv = psum_dot(rhat, v)
            alpha = rho_new / jnp.where(rv == 0, 1e-30, rv)
            s = r - alpha * v
            shat = apply_M(s)
            t = matvec(shat)
            # one stacked psum: t·t, t·s (omega needs both before r exists)
            tt, ts = jax.lax.psum(
                jnp.stack([jnp.vdot(t, t), jnp.vdot(t, s)]), axis_name)
            omega = jnp.where(tt == 0, 0.0, ts / jnp.where(tt == 0, 1e-30, tt))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            # recomputed norm (not the ss - 2w ts + w^2 tt recurrence): the
            # recurrence's fp32 cancellation can drift from |r|^2 over long
            # runs; one extra scalar psum is cheap next to two all_gathers
            rr_new = psum_dot(r, r)
            # rho/omega ~ 0 means the method has broken down — stop and
            # flag rather than iterating on 1e-30-substituted directions
            bad = (jnp.abs(rho_new) < eps_bd) | (jnp.abs(tt) < eps_bd)
            return (x, r, rho_new, alpha, omega, v, p, rr_new, bad, k + 1)

        z = jnp.zeros_like(b_loc)
        state = (x_loc, r, one, one, one, z, z, rr, jnp.asarray(False), 0)
        x, r, *_, rr, bad, k = jax.lax.while_loop(cond, body, state)
        return x, k, jnp.sqrt(jnp.maximum(rr, 0.0)), bad

    x, iters, residual, bad = run(part, b_pad, x0_pad,
                                  _precond_state(precond, part.n_shards))
    return SolveResult(x=x.reshape(-1)[:rows], iters=iters,
                       residual=residual, breakdown=bad)


def dist_gmres(part: PartitionedCSR, b, mesh: Mesh,
               axis_name: str = "shard",
               precond: Union[None, str, Callable] = None,
               x0=None, tol: float = 1e-6, restart: int = 20,
               maxiter: int = 50) -> SolveResult:
    """Restarted GMRES(m) for general row-partitioned ``A``.

    The whole restart cycle lives in one shard_map region.  The Krylov
    basis stays sharded as ``(restart+1, local_rows)``; per Arnoldi step
    the communication is one tiled all_gather (the matvec) and two stacked
    psums of length ``restart+1`` (classical Gram-Schmidt with one
    re-orthogonalization pass — CGS2, numerically equivalent to MGS but
    collective-friendly: two fixed-size reductions instead of ``j``
    serialized scalar ones).  The small ``H`` least-squares problem is
    replicated scalar math on every device.

    Args:
      restart: Arnoldi cycle length ``m`` (``m+1`` local bands are held).
      maxiter: maximum number of restart CYCLES.  ``iters`` in the result
        counts total inner steps (cycles × restart) — an UPPER bound when
        convergence happens mid-cycle, unlike dist_cg/dist_bicgstab whose
        ``iters`` are exact; compare solver costs by wall-clock or
        cycles, not by this field.
      precond: left preconditioner (None | "jacobi" | callable), applied
        as ``M⁻¹A``; stopping uses the TRUE residual recomputed per cycle.
    """
    _check_square_rows(part, "dist_gmres")
    rows, _ = part.shape
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")
    pad_len = part.n_shards * part.local_rows
    b_pad = _pad_vec(b, pad_len)
    x0_pad = _pad_vec(x0, pad_len) if x0 is not None else jnp.zeros_like(b_pad)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(), P()),
        # a ShardedPrecond state is per-shard by construction
        check_vma=False,
    )
    def run(p_local, b_loc, x_loc, m_local):
        matvec, apply_M = _local_env(part, p_local, precond, axis_name,
                                     m_local)
        nloc = b_loc.shape[0]
        dtype = b_loc.dtype

        def psum_dot(a, c):
            return jax.lax.psum(jnp.vdot(a, c), axis_name)

        bnorm = jnp.sqrt(jnp.maximum(psum_dot(b_loc, b_loc), 1e-60))
        steps = jnp.arange(m + 1)

        # fp32 matmuls may run as TF32 at DEFAULT precision on the GPU;
        # every V-involved product must run HIGHEST or the CGS2 basis
        # loses orthogonality and the residual stalls well above tol.
        hi = jax.lax.Precision.HIGHEST

        def arnoldi(j, carry):
            V, H = carry
            w = apply_M(matvec(V[j]))
            mask = (steps <= j).astype(dtype)
            # CGS2: project, then re-project the remainder (one pass of
            # re-orthogonalization recovers MGS-level stability).
            h1 = jax.lax.psum(jnp.dot(V, w, precision=hi), axis_name) * mask
            w = w - jnp.dot(h1, V, precision=hi)
            h2 = jax.lax.psum(jnp.dot(V, w, precision=hi), axis_name) * mask
            w = w - jnp.dot(h2, V, precision=hi)
            h = h1 + h2
            wnorm = jnp.sqrt(jnp.maximum(psum_dot(w, w), 0.0))
            # happy breakdown: when w is numerically inside span(V) (wnorm
            # at rounding level relative to the projected column), zero the
            # new basis vector and H[j+1, j] instead of normalizing noise
            # into V — lstsq's min-norm solution handles the zero column.
            hnorm = jnp.sqrt(jnp.maximum(jnp.vdot(h, h).real, 0.0))
            tiny = wnorm <= jnp.finfo(dtype).eps * jnp.maximum(hnorm, 1.0)
            wnorm_eff = jnp.where(tiny, 0.0, wnorm)
            H = H.at[:, j].set(h).at[j + 1, j].set(wnorm_eff)
            V = V.at[j + 1].set(
                jnp.where(tiny, 0.0, w / jnp.maximum(wnorm, 1e-30)))
            return V, H

        def cycle(state):
            x, rnorm, k = state
            r = apply_M(b_loc - matvec(x))
            beta = jnp.sqrt(jnp.maximum(psum_dot(r, r), 1e-60))
            V = jnp.zeros((m + 1, nloc), dtype).at[0].set(r / beta)
            H = jnp.zeros((m + 1, m), dtype)
            V, H = jax.lax.fori_loop(0, m, arnoldi, (V, H))
            # min-norm least squares tolerates the zero H columns left by
            # early breakdown (converged-inside-the-cycle), so running the
            # cycle to fixed length m stays correct.
            e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
            y = jnp.linalg.lstsq(H, e1)[0]
            x = x + jnp.dot(y, V[:m], precision=hi)
            r_true = b_loc - matvec(x)
            rnorm = jnp.sqrt(jnp.maximum(psum_dot(r_true, r_true), 0.0))
            return x, rnorm, k + 1

        def cond(state):
            _, rnorm, k = state
            return jnp.logical_and(k < maxiter, rnorm / bnorm > tol)

        r0 = b_loc - matvec(x_loc)
        rnorm0 = jnp.sqrt(jnp.maximum(psum_dot(r0, r0), 0.0))
        x, rnorm, k = jax.lax.while_loop(cond, cycle, (x_loc, rnorm0, 0))
        return x, k * m, rnorm

    x, iters, residual = run(part, b_pad, x0_pad,
                             _precond_state(precond, part.n_shards))
    return SolveResult(x=x.reshape(-1)[:rows], iters=iters,
                       residual=residual)
