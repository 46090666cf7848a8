#!/usr/bin/env python
"""Driver benchmark: prints ONE JSON line with the headline metric.

Headline = the reference's own benchmark workload (sparse AddMatMat,
m×n×k = 117×1023×2047, 25%-dense codebook-quantized B, fp32;
reference src/test/blas_test.cc:32) run through this framework's
jitted path.  ``vs_baseline`` is the reference's published AVX2 figure
(~7.5 ms, kernel.cc:381) divided by our measured min time.
"""
import json


def main():
    from sparsematrix_tpu.bench.suite import bench_codebook_gemm
    from sparsematrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # the framework's recommended paths for this workload; the full
    # comparison matrix lives in the suite CLI
    rows = bench_codebook_gemm(
        check=True,
        variants=("csr-auto", "dense-dequant", "dense-dequant-bf16",
                  "int8-gemm", "int16-gemm"),
    )
    # headline = fastest SPARSE path that passes the reference's oracle
    # check (the dense-race rows are the honesty races, not the headline)
    sparse = [r for r in rows if "dense-race" not in r.name]
    ok = [r for r in sparse if r.checked] or sparse
    r = min(ok, key=lambda r: r.result.min_ms)
    out = {
        "metric": "codebook_sparse_gemm_117x1023x2047_ms",
        "path": r.name,
        "value": round(r.result.min_ms, 4),
        "unit": "ms",
        "vs_baseline": round(r.extras["vs_baseline"], 2),
        "checked": r.checked,
        "nnz": r.nnz,
        "gnnz_per_s": round(r.nnz_per_s / 1e9, 3),
        "mean_ms": round(r.result.mean_ms, 4),
        "compile_ms": round(r.result.compile_ms, 1),
    }
    # the on-device honesty race (dense GEMM of the same problem on the
    # same device — the reference harness's blas_test.cc:41 stance)
    for rr in rows:
        if rr.name == "codebook_gemm/dense-race-fp32":
            out["dense_race_fp32_ms"] = round(rr.result.min_ms, 4)
        elif rr.name == "codebook_gemm/dense-race-bf16":
            out["dense_race_bf16_ms"] = round(rr.result.min_ms, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
