"""Benchmark CLI mirroring blas_test's ergonomics
(reference src/test/blas_test.cc:32-37):

    python -m sparsematrix_tpu.bench [m] [n] [k] [check] [filter]

``m/n/k`` accept ``begin:end`` doubling sweeps; ``check`` toggles oracle
verification; ``filter`` is a comma-separated regex list, ``-pat`` excludes.
"""
from __future__ import annotations

import sys

from .harness import BenchFilter, StepList
from .suite import REF_K, REF_M, REF_N, registry


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    import os
    import time

    budget = os.environ.get("BENCH_BUDGET")
    deadline = time.monotonic() + float(budget) if budget else None
    m = StepList(argv[0]) if len(argv) > 0 else StepList(REF_M)
    n = StepList(argv[1]) if len(argv) > 1 else StepList(REF_N)
    k = StepList(argv[2]) if len(argv) > 2 else StepList(REF_K)
    check = bool(int(argv[3])) if len(argv) > 3 else True
    filt = BenchFilter(argv[4] if len(argv) > 4 else None)

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    for mi in m:
        for ni in n:
            for ki in k:
                registry.run(filt, check=check, ref_m=mi, ref_n=ni, ref_k=ki,
                             deadline=deadline)
    registry.print_table()

    json_path = argv[5] if len(argv) > 5 else None
    if json_path:
        import json

        rows = [
            {
                "name": r.name,
                "shape": r.shape,
                "min_ms": r.result.min_ms,
                "mean_ms": r.result.mean_ms,
                "gnnz_per_s": r.nnz_per_s / 1e9,
                "sol_frac": r.sol_frac,
                "checked": r.checked,
                "nnz": r.nnz,
                **({"extras": r.extras} if getattr(r, "extras", None) else {}),
            }
            for r in registry.rows
        ]
        with open(json_path, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
