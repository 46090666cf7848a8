"""Profiling hooks: jax.profiler traces + named time probes.

The equivalent of the reference's DEBUG-gated probes
(reference src/utils/dev-tools.h:18-31): ``time_probe`` accumulates
named wall-clock spans (host-side, cheap, always available);
``device_trace`` wraps a region in a jax.profiler trace for in-depth
device-level analysis (view with TensorBoard / xprof).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import jax

__all__ = ["time_probe", "probe_totals", "reset_probes", "device_trace",
           "annotate"]

_probes: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def time_probe(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _probes[name] += time.perf_counter() - t0
        _counts[name] += 1


def probe_totals() -> Dict[str, tuple]:
    """{name: (total_ms, count)}"""
    return {k: (v * 1e3, _counts[k]) for k, v in _probes.items()}


def reset_probes() -> None:
    _probes.clear()
    _counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace for the enclosed region."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace annotation usable inside jitted regions."""
    return jax.profiler.TraceAnnotation(name)
