"""Wall-clock timing utilities.

``Timer`` mirrors the reference's accumulator semantics
(reference src/utils/utility.h:11-48: start/stop/pause/elapsed_ms);
``bench_fn`` adds device-aware timing: it block_until_ready()s results so
async dispatch doesn't fake speedups, and separates compile (first call)
from steady-state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import jax

__all__ = ["Timer", "bench_fn", "bench_chain_slope", "BenchResult"]


class Timer:
    def __init__(self):
        self._start = None
        self._accum = 0.0

    def start(self):
        self._accum = 0.0
        self._start = time.perf_counter()
        return self

    def pause(self):
        if self._start is not None:
            self._accum += time.perf_counter() - self._start
            self._start = None
        return self

    def resume(self):
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        self.pause()
        return self._accum * 1e3

    @property
    def elapsed_ms(self) -> float:
        extra = time.perf_counter() - self._start if self._start is not None else 0.0
        return (self._accum + extra) * 1e3


@dataclass
class BenchResult:
    mean_ms: float
    min_ms: float
    compile_ms: float
    iters: int
    extras: Dict[str, Any] = field(default_factory=dict)


def _block(x):
    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return x


def _fetch_one(x):
    """Force completion via a 1-element VALUE fetch: a data dependency
    on the result that no early readiness signal can satisfy.  Transfer
    cost: 4 bytes."""
    import numpy as _np

    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "block_until_ready"):
            _np.asarray(leaf.reshape(-1)[:1])
    return x


def bench_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> BenchResult:
    t0 = time.perf_counter()
    _block(fn(*args))
    compile_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(warmup):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return BenchResult(
        mean_ms=sum(times) / len(times),
        min_ms=min(times),
        compile_ms=compile_ms,
        iters=iters,
    )


def bench_chain_slope(step: Callable, x0, *extra, inner_lo: int = 8,
                      inner_hi: int = 72, iters: int = 8) -> BenchResult:
    """Slope-time a self-dependent chain ``y ← step(y)`` (y0 = x0).

    For ops where `_looped`'s additive scalar perturbation is unsafe —
    XLA's algebraic simplifier can distribute ``dot(a+ε, a+ε)`` into one
    ``dot(a, a)`` plus rank-1 terms, collapsing the measurement (observed
    once: 8 "matmuls" in 73 µs).  A value chain admits no such rewrite
    (floats don't reassociate), so each link costs one real op.  ``step``
    must be shape-preserving and keep magnitudes bounded (e.g. scale a
    matmul by ~1/n).

    ``extra`` operands are threaded through as jit ARGUMENTS — pass any
    large constants (matrices, plans) here rather than closing over them,
    or they get embedded in the HLO as constants.
    """
    import jax

    def chained(inner):
        @jax.jit
        def run(y, *ex):
            return jax.lax.fori_loop(0, inner, lambda i, y: step(y, *ex), y)

        return run

    lo, hi = chained(inner_lo), chained(inner_hi)
    t0 = time.perf_counter()
    _fetch_one(lo(x0, *extra))
    _fetch_one(hi(x0, *extra))
    compile_ms = (time.perf_counter() - t0) * 1e3

    def sample(g):
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            _fetch_one(g(x0, *extra))
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    t_lo, t_hi = sample(lo), sample(hi)
    per_op = max((t_hi - t_lo) / (inner_hi - inner_lo), 1e-6)
    return BenchResult(
        mean_ms=per_op, min_ms=per_op, compile_ms=compile_ms, iters=iters,
        extras={"t_lo_ms": t_lo, "t_hi_ms": t_hi,
                "inner": (inner_lo, inner_hi),
                "unreliable": bool(t_hi - t_lo < 0.5)},
    )


def _looped(fn: Callable, n_args: int, inner: int,
            perturb_max_bytes: int | None = None):
    """Build a jitted wrapper running ``fn`` ``inner`` times in one device
    computation.  The loop counter perturbs **every** float leaf of every
    argument by a denormal-scale epsilon so XLA cannot hoist any part of
    the body out of the loop (an unperturbed operand makes its whole
    dataflow cone loop-invariant); a scalar probe of each output forces
    full evaluation.

    ``perturb_max_bytes``: leaves LARGER than this are left unperturbed.
    Perturbing an operand materializes a fresh copy of it every
    iteration — for a packed-kernel argument holding hundreds of MB of
    slab values, that rewrite dwarfs the kernel itself (measured 2.5×
    overstatement at 16.6 M nnz).  Only set it when the big operand feeds
    the timed op DIRECTLY (no host-visible preprocessing XLA could hoist
    out of the loop — e.g. NOT for densify/dequant paths, whose
    A-transform is part of what's being timed).  The SMALLEST float leaf
    is always perturbed regardless of the cap — with every operand
    loop-invariant XLA hoists the whole op and the measurement collapses
    to ~0 (measured 3500× understatement)."""
    import jax
    import jax.numpy as jnp

    def probe(out):
        # must demand EVERY output leaf in full AND be non-simplifiable:
        #  * probing out[0] lets XLA slice pure matmuls to one output row
        #  * a linear sum(out) distributes through scatter-add, deleting
        #    the scatter entirely (sum∘segment_sum → direct reduce)
        # sum(|leaf|) over every inexact leaf is nonlinear, so neither
        # rewrite applies and no leaf's dataflow cone is dead code (a
        # container-returning fn would otherwise be sliced to its first
        # leaf, often a pass-through index plane).
        total = jnp.float32(0.0)
        for leaf in jax.tree_util.tree_leaves(out):
            leaf = jnp.asarray(leaf)
            if jnp.issubdtype(leaf.dtype, jnp.inexact):
                total = total + jnp.sum(jnp.abs(leaf.astype(jnp.float32)))
        return total

    @jax.jit
    def run(*args):
        def body(i, acc):
            # chain each iteration's inputs on the previous output (the
            # 1e-45 factor flushes to zero numerically but XLA cannot
            # prove it, so no iteration can be eliminated or overlapped
            # away) plus a counter epsilon against loop-invariant hoisting
            eps = (
                jnp.asarray(i, jnp.float32) * jnp.float32(1e-30)
                + acc * jnp.float32(1e-45)
            )
            flat, treedef = jax.tree_util.tree_flatten(args)
            fsizes = [
                (jnp.asarray(a).size * jnp.asarray(a).dtype.itemsize
                 if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                 else None)
                for a in flat
            ]
            fvals = [sz for sz in fsizes if sz is not None]
            min_f = min(fvals) if fvals else None

            def _maybe_perturb(a, sz):
                if sz is None:
                    return a
                if (perturb_max_bytes is not None
                        and sz > perturb_max_bytes and sz != min_f):
                    return a
                return a + eps.astype(jnp.asarray(a).dtype)

            perturbed = treedef.unflatten(
                [_maybe_perturb(a, sz) for a, sz in zip(flat, fsizes)])
            out = fn(*perturbed)
            return acc + probe(out)

        return jax.lax.fori_loop(0, inner, body, jnp.float32(0.0))

    return run


def bench_fn_slope(fn: Callable, *args, inner_lo: int = 8, inner_hi: int = 72,
                   iters: int = 8, warmup: int = 1,
                   max_escalations: int = 2,
                   perturb_max_bytes: int | None = None) -> BenchResult:
    """Dispatch-latency-immune timing: run ``fn`` inner_lo and inner_hi
    times inside single device computations; the per-op time is the slope
    (T_hi - T_lo) / (inner_hi - inner_lo), which cancels any constant
    host↔device round-trip cost.

    If the hi-lo delta lands below the ~ms dispatch-jitter floor (op too
    fast for these inner counts to resolve), the inner counts escalate 8×
    and the measurement repeats, up to ``max_escalations`` times.
    """
    total_compile = 0.0

    def measure(n_lo, n_hi):
        nonlocal total_compile
        lo = _looped(fn, len(args), n_lo, perturb_max_bytes)
        hi = _looped(fn, len(args), n_hi, perturb_max_bytes)
        t0 = time.perf_counter()
        # _fetch_one: a value fetch cannot complete before the device
        # work that produced it
        _fetch_one(lo(*args))
        _fetch_one(hi(*args))
        total_compile += (time.perf_counter() - t0) * 1e3
        for _ in range(warmup):
            _fetch_one(lo(*args))
            _fetch_one(hi(*args))

        def sample(g):
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                _fetch_one(g(*args))
                best = min(best, time.perf_counter() - t0)
            return best * 1e3

        return sample(lo), sample(hi)

    n_lo, n_hi = inner_lo, inner_hi
    for attempt in range(max_escalations + 1):
        t_lo, t_hi = measure(n_lo, n_hi)
        delta = t_hi - t_lo
        if delta >= 0.5 or attempt == max_escalations:
            break
        n_lo, n_hi = n_lo * 8, n_hi * 8

    per_op = max(delta / (n_hi - n_lo), 1e-6)
    return BenchResult(
        mean_ms=per_op,
        min_ms=per_op,
        compile_ms=total_compile,
        iters=iters,
        extras={"t_lo_ms": t_lo, "t_hi_ms": t_hi, "inner": (n_lo, n_hi),
                "unreliable": bool(delta < 0.5)},
    )
