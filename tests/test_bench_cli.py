"""Bench harness end-to-end on CPU with tiny shapes (jnp paths only)."""
import json

from sparsematrix_tpu.bench.cli import main
from sparsematrix_tpu.bench.harness import BenchFilter
from sparsematrix_tpu.bench.suite import bench_codebook_gemm, registry


def test_codebook_bench_small_runs():
    rows = bench_codebook_gemm(check=True, ref_m=8, ref_n=64, ref_k=96,
                               variants=("csr-auto",))
    assert rows and rows[0].checked
    assert rows[0].extras["vs_baseline"] > 0


def test_cli_writes_json(tmp_path, capsys):
    out = tmp_path / "rows.json"
    # run only the codebook bench at tiny shape
    main(["8", "64", "96", "1", "codebook", str(out)])
    captured = capsys.readouterr().out
    assert "codebook_gemm" in captured
    rows = json.loads(out.read_text())
    assert rows and all("min_ms" in r for r in rows)


def test_filter_excludes():
    f = BenchFilter("codebook,-int8")
    assert f.accept("codebook_gemm/csr-auto")
    assert not f.accept("codebook_gemm/int8-gemm")
