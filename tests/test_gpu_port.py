"""The platform rule, the roofline table, the compile-cache helper and
``chip_smoke.py``'s phases, exercised on the CPU at a tiny size."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import chip_smoke
from sparsematrix_tpu.config import Config, config
from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.parallel import (dist_spmv_halo_var, make_mesh,
                                       partition_csr_halo_var)
from sparsematrix_tpu.utils.compile_cache import enable_compile_cache
from sparsematrix_tpu.utils.roofline import CHIPS, chip_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_pallas():
    code = ("import sys, sparsematrix_tpu, sparsematrix_tpu.bench.suite; "
            "print([m for m in sys.modules if 'pallas' in m])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         check=True).stdout
    assert out.strip() == "[]", out


def test_config_has_no_kernel_knobs():
    for name in ("interpret", "use_pallas", "kernel_impl",
                 "pallas_interpret"):
        assert not hasattr(config, name), name


@pytest.mark.parametrize("backend,ragged", [("gpu", True), ("cpu", False)])
def test_halo_branch_follows_platform_rule(monkeypatch, backend, ragged):
    n, shards = 64, 4
    dense = np.zeros((n, n), np.float32)
    for i in range(n):
        dense[i, max(0, i - 2):i + 3] = 1.0
    mesh = make_mesh(shards)
    part = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("shard"))),
        partition_csr_halo_var(CSR.fromdense(dense), shards))
    monkeypatch.setattr(config, "_backend", backend)
    jaxpr = str(jax.make_jaxpr(lambda p, v: dist_spmv_halo_var(p, v, mesh))(
        part, jnp.ones(n, jnp.float32)))
    assert ("ragged_all_to_all" in jaxpr) is ragged
    assert ("ppermute" in jaxpr) is not ragged
    assert Config(_backend=backend).ragged_halo() is ragged


def test_roofline_known_device_resolves():
    spec = chip_spec("NVIDIA H100 80GB HBM3")
    assert spec.hbm_gbps == 3350.0
    assert (spec.bf16_tflops, spec.tf32_tflops, spec.fp32_tflops) == (
        989.0, 495.0, 67.0)
    assert set(CHIPS) == {"NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA H100 PCIe",
                                  ""])
def test_roofline_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no roofline entry"):
        chip_spec(kind)


def test_roofline_defaults_to_running_device():
    with pytest.raises(ValueError, match=repr(jax.devices()[0].device_kind)):
        chip_spec()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old  # nothing was set


def test_compile_cache_default_is_the_checkout(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    try:
        path = enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# ---------------------------------------------------------------------------
# chip_smoke.py: phases at a tiny size, against their references
# ---------------------------------------------------------------------------

CTX = chip_smoke.Ctx(card="cpu test", bw=None, reps=1)


def test_smoke_uniform_matrix_has_distinct_sorted_columns():
    sp = chip_smoke.uniform_csr(1024, 8, seed=0)
    assert sp.nnz == 1024 * 8
    cols = sp.indices.reshape(1024, 8)
    assert (np.diff(cols, axis=1) > 0).all() and cols.max() < 1024


def test_smoke_phase_spmv():
    chip_smoke.phase_spmv(CTX, n=2048, per_row=8)


def test_smoke_phase_spmm():
    chip_smoke.phase_spmm(CTX, n=2048, per_row=8, k=4, band=96)


def test_smoke_phase_codebook():
    chip_smoke.phase_codebook(CTX, parity=(7, 90, 120), card=(8, 256, 256),
                              n_cols=16)


def test_smoke_phase_spgemm():
    chip_smoke.phase_spgemm(CTX, side=16)


def test_smoke_phase_solve():
    chip_smoke.phase_solve(CTX, side=16)


def test_smoke_phase_four_on_virtual_devices():
    # XLA:CPU has no ragged-all-to-all kernel: the padded branch only
    chip_smoke.phase_four(CTX, n=2048, per_row=8, k=4, band=8, side=16,
                          ragged=(False,))


def test_smoke_report_fails_over_tolerance(capsys):
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke.report(CTX, "op", "shape", 1, 1, "fp32", 2e-5, 1e-5, 1.0)
    assert "err=2.000e-05" in capsys.readouterr().out


def test_smoke_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    captured = capsys.readouterr()
    assert "no GPU found" in captured.err
    assert '"ok"' not in captured.out


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest tests -m gpu)")
    return chip_smoke.Ctx(card=chip_smoke.card_info(), bw=None, reps=1)


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    chip_smoke.phase_spmv(gpu, n=1 << 16, per_row=16)
    chip_smoke.phase_spmm(gpu, n=1 << 14, per_row=16, k=8)
    chip_smoke.phase_codebook(gpu, card=(64, 2048, 2048), n_cols=64)
    chip_smoke.phase_spgemm(gpu, side=128)
    chip_smoke.phase_solve(gpu, side=64)
