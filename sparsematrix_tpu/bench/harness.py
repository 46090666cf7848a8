"""Benchmark harness with the reference CLI's ergonomics.

Replicates the capability set of `blas_test`
(reference src/test/blas_test.{h,cc}): named benchmark registry,
regex include/exclude filters (``-pattern`` = exclude, blas_test.h:31-42),
``begin:end`` doubling shape sweeps (StepList, blas_test.h:50-63),
an oracle-check toggle, and a timing table (TimeStatis, blas_test.h:65-98)
— extended with nnz/s and roofline % columns.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..utils.timer import BenchResult

__all__ = ["StepList", "BenchFilter", "BenchRegistry", "Row"]


class StepList:
    """Parse ``"begin:end"`` into a doubling sweep, or a single value."""

    def __init__(self, spec: str | int):
        if isinstance(spec, int):
            self.values = [spec]
            return
        if ":" in spec:
            b, e = spec.split(":")
            b, e = int(b), int(e)
            vals = []
            v = b
            while v <= e:
                vals.append(v)
                v *= 2
            self.values = vals
        else:
            self.values = [int(spec)]

    def __iter__(self):
        return iter(self.values)


class BenchFilter:
    """Regex include/exclude: ``-pat`` excludes, ``pat`` includes
    (blas_test.h:31-42)."""

    def __init__(self, patterns: Optional[str] = None):
        self.includes: List[re.Pattern] = []
        self.excludes: List[re.Pattern] = []
        if patterns:
            for p in patterns.split(","):
                p = p.strip()
                if not p:
                    continue
                if p.startswith("-"):
                    self.excludes.append(re.compile(p[1:]))
                else:
                    self.includes.append(re.compile(p))

    def accept(self, name: str) -> bool:
        if any(p.search(name) for p in self.excludes):
            return False
        if self.includes:
            return any(p.search(name) for p in self.includes)
        return True


@dataclass
class Row:
    name: str
    shape: str
    result: BenchResult
    nnz: int = 0
    checked: Optional[bool] = None
    sol_frac: Optional[float] = None  # fraction of speed-of-light

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / (self.result.min_ms * 1e-3) if self.nnz else 0.0


class BenchRegistry:
    def __init__(self):
        self._benches: Dict[str, Callable] = {}
        self.rows: List[Row] = []

    def register(self, name: str):
        def deco(fn):
            self._benches[name] = fn
            return fn

        return deco

    def run(self, filt: BenchFilter, skip=None, deadline=None,
            **kwargs) -> List[Row]:
        """``deadline`` (time.monotonic() stamp) stops cleanly BEFORE the
        next group starts — so an external ``timeout`` never kills the
        process mid-group and the partial JSON still gets written.  A
        group that raises ends the run."""
        import time

        for name, fn in self._benches.items():
            if not filt.accept(name) or (skip and name in skip):
                continue
            if deadline is not None and time.monotonic() > deadline:
                print(f"[budget] BENCH_BUDGET exhausted — skipping {name} "
                      "and the rest of this sweep", flush=True)
                break
            rows = fn(**kwargs)
            rows = rows if isinstance(rows, list) else [rows]
            kept = []
            for r in rows:
                sol = f"{100*r.sol_frac:.1f}%" if r.sol_frac is not None else "-"
                if r.result.extras.get("unreliable"):
                    # a measurement whose hi-lo slope delta never rose
                    # above the dispatch-jitter floor is noise, not data —
                    # it must not ship next to real numbers
                    print(f"[drop] {r.name} {r.shape} UNRELIABLE "
                          f"(delta below jitter floor after escalation)",
                          flush=True)
                    continue
                print(f"[row] {r.name} {r.shape} min={r.result.min_ms:.4f}ms "
                      f"gnnz/s={r.nnz_per_s/1e9:.2f} sol={sol} "
                      f"check={r.checked}", flush=True)
                kept.append(r)
            self.rows.extend(kept)
        return self.rows

    def print_table(self):
        hdr = f"{'bench':<34} {'shape':<22} {'min ms':>9} {'mean ms':>9} {'Gnnz/s':>8} {'SoL%':>6} {'check':>6}"
        print(hdr)
        print("-" * len(hdr))
        for r in self.rows:
            sol = f"{100*r.sol_frac:.1f}" if r.sol_frac is not None else "-"
            chk = {True: "ok", False: "FAIL", None: "-"}[r.checked]
            print(
                f"{r.name:<34} {r.shape:<22} {r.result.min_ms:>9.3f} "
                f"{r.result.mean_ms:>9.3f} {r.nnz_per_s/1e9:>8.2f} {sol:>6} {chk:>6}"
            )
