"""Benchmark suite: named groups of timed, oracle-checked rows.

1. csr_spmv        — CSR SpMV sweep (random + banded, nnz/row 4–128)
2. spmm_csr        — CSR × dense RHS, k = 32/128/512 (jnp + densify paths)
3. spmm_bell       — blocked-ELL SpMM (gathered blocks + einsum)
4. bsr             — BSR SpMV/SpMM
5. codebook_gemm   — the reference's own headline workload:
                     C = A(117×2047) @ B(2047×1023), B codebook-sparse 25%
                     (m,n,k defaults from blas_test.cc:32; baseline 7.5 ms
                     on AVX2, kernel.cc:381)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR, CodebookCSR, csr_to_blocked_ell, csr_to_bsr
from ..ops import (add_mat_mat, spmm, spmm_densify, spmm_reference, spmv,
                   spmv_reference)
from ..utils.precision import matmul_precision
from ..utils.roofline import speed_of_light_nnz_s, spmm_bytes, spmv_csr_bytes
from ..utils.testutils import (
    gen_matrix_random,
    gen_random_dense_sparse,
    gen_sparse_index_matrix,
    relative_check,
)
from ..utils.timer import bench_chain_slope, bench_fn_slope
from .harness import BenchRegistry, Row

registry = BenchRegistry()

REF_M, REF_N, REF_K = 117, 1023, 2047  # blas_test.cc:32 defaults
REF_BASELINE_MS = 7.5  # kernel.cc:381 (x86 AVX2 path)


def _dense_race_row(tag, dense_np, rhs, nnz):
    """The on-device dense baseline the reference harness always races
    against (blas_test.cc:41 → cblas_sgemm_baseline): same shape, plain
    jnp.dot.  nnz/s here is *effective* (sparse-equivalent
    work per second) so rows are directly comparable."""
    dd = jnp.asarray(dense_np)
    f = jax.jit(lambda m, v: jnp.dot(m, v, precision=matmul_precision(m.dtype)))
    res = bench_fn_slope(f, dd, rhs, iters=6, perturb_max_bytes=1 << 20)
    n, m = dense_np.shape
    # include the RHS width so per-k races stay distinct rows in merges
    k_str = f",k={rhs.shape[1]}" if rhs.ndim == 2 else ""
    r = Row(f"{tag}/dense-race", f"{n}x{m}{k_str} dense", res,
            nnz=nnz)
    r.sol_frac = None  # roofline basis differs; Gnnz/s column is the race
    return r


def _banded(rng, n, bandwidth):
    dense = np.zeros((n, n), dtype=np.float32)
    for off in range(-bandwidth // 2, bandwidth // 2 + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        dense[idx, idx + off] = rng.uniform(-1, 1, idx.shape[0])
    return dense


@registry.register("csr_spmv")
def bench_csr_spmv(check=True, sizes=(4096,), **kw):
    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        for nnz_row in (4, 16, 64, 128):
            density = nnz_row / n
            dense = gen_random_dense_sparse(rng, n, n, density=density)
            A = CSR.fromdense(dense)
            x = jnp.asarray(gen_matrix_random(rng, n, 1)[:, 0])
            f = jax.jit(lambda a, v: spmv(a, v))
            res = bench_fn_slope(f, A, x, iters=6)
            checked = None
            if check:
                checked = relative_check(np.asarray(f(A, x)), dense @ np.asarray(x))
            sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
            r = Row("csr_spmv/random", f"n={n},nnz/row={nnz_row}", res,
                    nnz=A.nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        # encode-once convention: jit closes over the CONCRETE container
        # (the reference's one-call contract, sparse-matrix.cc:140)
        dense = gen_random_dense_sparse(rng, n, n, density=128 / n)
        A = CSR.fromdense(dense)
        x = jnp.asarray(gen_matrix_random(rng, n, 1)[:, 0])
        fa = jax.jit(lambda v: spmv(A, v))
        res = bench_fn_slope(fa, x, iters=6)
        checked = None
        if check:
            checked = relative_check(np.asarray(fa(x)), dense @ np.asarray(x))
        sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
        r = Row("csr_spmv/auto", f"n={n},nnz/row=128 (closed-over)",
                res, nnz=A.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        rows.append(r)
        # dense race at the densest config
        rows.append(_dense_race_row("csr_spmv", dense, x, A.nnz))
        for bw in (9, 65):
            dense = _banded(rng, n, bw)
            A = CSR.fromdense(dense)
            x = jnp.asarray(gen_matrix_random(rng, n, 1)[:, 0])
            f = jax.jit(lambda a, v: spmv(a, v))
            res = bench_fn_slope(f, A, x, iters=6)
            checked = (
                relative_check(np.asarray(f(A, x)), dense @ np.asarray(x))
                if check
                else None
            )
            sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
            r = Row("csr_spmv/banded", f"n={n},band={bw}", res, nnz=A.nnz,
                    checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
            # the band-local layout: strip-dense batched matvec
            from ..formats import StripDense

            S = StripDense.from_csr(A)
            fs = jax.jit(spmv_reference)
            res = bench_fn_slope(fs, S, x, iters=6, perturb_max_bytes=1 << 20)
            checked = (
                relative_check(np.asarray(fs(S, x)), dense @ np.asarray(x))
                if check
                else None
            )
            sol = speed_of_light_nnz_s(
                A.nnz, spmv_csr_bytes(S.strips.size, n, n, idx_bytes=0))
            r = Row("csr_spmv/banded-strip",
                    f"n={n},band={bw},width={S.width}", res, nnz=A.nnz,
                    checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
    return rows


@registry.register("csr_spmv_large")
def bench_csr_spmv_large(check=True, n=8192, nnz_row=256, **kw):
    """≥2 M nnz CSR SpMV (gather + segment-sum), raced against the dense
    matvec."""
    rng = np.random.default_rng(7)
    dense = gen_random_dense_sparse(rng, n, n, density=nnz_row / n)
    A = CSR.fromdense(dense)
    x = jnp.asarray(gen_matrix_random(rng, n, 1)[:, 0])
    f = jax.jit(lambda a, v: spmv(a, v))
    # VALUE CHAIN (y ← A·y rescaled): `_looped` perturbation would rewrite
    # the matrix planes every iteration and overstate the op
    chain_scale = jnp.float32(2.0 ** -16)
    res = bench_chain_slope(lambda y, a: f(a, y) * chain_scale, x, A,
                            iters=6)
    checked = (relative_check(np.asarray(f(A, x)),
                              dense.astype(np.float64) @ np.asarray(x))
               if check else None)
    sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
    r = Row("csr_spmv_large/csr-fp32", f"n={n},nnz/row={nnz_row}", res,
            nnz=A.nnz, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    return [r, _dense_race_row("csr_spmv_large", dense, x, A.nnz)]


@registry.register("spmm_csr")
def bench_spmm_csr(check=True, n=2048, density=0.05, ks=(32, 128, 512), **kw):
    from ..formats import Dense

    rng = np.random.default_rng(1)
    dense = gen_random_dense_sparse(rng, n, n, density=density)
    A = CSR.fromdense(dense)
    D = Dense.from_sparse(A)  # build-time materialization (dense regime)
    # quantized pre-dense containers: bf16 halves the dominant A plane
    # and runs on the bf16 tensor cores; int8 halves it again (the reference's own
    # codebook-quantization trade, blas_test.h:139-145, generalized via
    # per-row scales).  Checked against the fp64 oracle with the
    # reference's 0.1 relative policy — measured error ~1e-2 / ~4e-3.
    from ..formats import QuantDense

    Dbf = Dense.from_sparse(A, dtype=jnp.bfloat16)
    Q = QuantDense.from_sparse(A)
    rows = []
    for k in ks:
        X = jnp.asarray(gen_matrix_random(rng, n, k))
        for label, f, op in (
            ("spmm_csr/segsum", jax.jit(functools.partial(spmm_reference)), A),
            ("spmm_csr/densify", jax.jit(functools.partial(spmm_densify)), A),
            ("spmm_csr/pre-dense", jax.jit(lambda a, x: spmm(a, x)), D),
            ("spmm_csr/pre-dense-bf16", jax.jit(lambda a, x: spmm(a, x)), Dbf),
            ("spmm_csr/pre-dense-int8", jax.jit(lambda a, x: spmm(a, x)), Q),
        ):
            res = bench_fn_slope(f, op, X, iters=6)
            checked = None
            if check:
                got = np.asarray(f(op, X))
                want = dense.astype(np.float64) @ np.asarray(X)
                if label.endswith(("bf16", "int8")):
                    # quantized paths: error is ~1e-2 of the OUTPUT SCALE
                    # (operand rounding) — scale-floored policy, same as
                    # the codebook group's bf16/int8 checks
                    from ..utils.testutils import quantized_check

                    checked = quantized_check(
                        got, want,
                        med_tol=0.04 if label.endswith("int8") else 0.02,
                        q99_tol=0.2 if label.endswith("int8") else 0.1)
                else:
                    checked = relative_check(got, want)
            sol = speed_of_light_nnz_s(A.nnz, spmm_bytes(A.nnz, n, n, k))
            r = Row(label, f"n={n},k={k},d={density}", res, nnz=A.nnz,
                    checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        rows.append(_dense_race_row("spmm_csr", dense, X, A.nnz))
    return rows


@registry.register("spmm_bell")
def bench_spmm_bell(check=True, n=2048, density=0.05, ks=(128, 512), **kw):
    """Blocked-ELL on two inputs: unstructured sparsity forced into (8,128)
    blocks (~99 % block padding — the layout-mismatch case) and
    BLOCK-STRUCTURED sparsity at (128,128) blocks, where every stored
    block is a full dense tile."""

    rng = np.random.default_rng(2)
    rows = []

    # (a) unstructured → (8,128) blocks: ~99% block padding, layout mismatch
    dense_u = gen_random_dense_sparse(rng, n, n, density=density)
    bell_u = csr_to_blocked_ell(CSR.fromdense(dense_u), block_shape=(8, 128))
    # (b) block-structured → (128,128) blocks, density of BLOCK slots
    bm = bk = 128
    mask = rng.random((n // bm, n // bk)) < density
    dense_b = (np.kron(mask, np.ones((bm, bk))).astype(np.float32)
               * gen_matrix_random(rng, n, n))
    bell_b = csr_to_blocked_ell(CSR.fromdense(dense_b),
                                block_shape=(bm, bk))
    for tag, dense, bell in (("unstructured-8x128", dense_u, bell_u),
                             ("blockstruct-128x128", dense_b, bell_b)):
        nnz = int((dense != 0).sum())
        for k in ks:
            X = jnp.asarray(gen_matrix_random(rng, n, k))
            f = jax.jit(spmm_reference)
            res = bench_fn_slope(f, bell, X, iters=6, perturb_max_bytes=1 << 20)
            checked = None
            if check:
                checked = relative_check(
                    np.asarray(f(bell, X)),
                    dense.astype(np.float64) @ np.asarray(X))
            # roofline accounts the padded blocks actually streamed
            bbm, bbk = bell.block_shape
            eff_nnz = bell.num_block_rows * bell.max_blocks_per_row * bbm * bbk
            sol = speed_of_light_nnz_s(
                nnz, spmm_bytes(eff_nnz, n, n, k, idx_bytes=0))
            r = Row(f"spmm_bell/{tag}", f"n={n},k={k},d={density}", res,
                    nnz=nnz, checked=checked)
            r.sol_frac = r.nnz_per_s / sol
            rows.append(r)
        # race each input against plain dense
        rows.append(_dense_race_row(f"spmm_bell/{tag}", dense, X, nnz))
    return rows


@registry.register("spmm_banded")
def bench_spmm_banded(check=True, n=4096, k=128, **kw):
    """Band-local structure (block-tridiagonal, the FEM/stencil shape):
    StripDense locally densifies each 128-row strip and batch-matmuls it,
    vs the (8,128) blocked-ELL layout on the same matrix, vs the dense
    race."""
    from ..formats import StripDense

    rng = np.random.default_rng(12)
    bs = 128  # block size: block-tridiagonal -> strips span <= 3 blocks
    nb = n // bs
    mask = np.zeros((nb, nb), bool)
    for o in (-1, 0, 1):
        idx = np.arange(max(0, -o), nb - max(0, o))
        mask[idx, idx + o] = True
    dense = (np.kron(mask, np.ones((bs, bs))).astype(np.float32)
             * gen_matrix_random(rng, n, n))
    csr = CSR.fromdense(dense)
    nnz = csr.nnz
    S = StripDense.from_csr(csr)
    bell = csr_to_blocked_ell(csr, block_shape=(8, 128))
    X = jnp.asarray(gen_matrix_random(rng, n, k))
    x = jnp.asarray(gen_matrix_random(rng, n, 1)[:, 0])
    oracle = dense.astype(np.float64) @ np.asarray(X)
    rows = []

    for tag, f, args, eff, idxb in (
        ("strip-spmm", jax.jit(spmm_reference), (S, X), S.strips.size, 0),
        ("bell-spmm", jax.jit(spmm_reference), (bell, X),
         bell.num_block_rows * bell.max_blocks_per_row * 8 * 128, 0),
    ):
        res = bench_fn_slope(f, *args, iters=6, perturb_max_bytes=1 << 20)
        checked = (relative_check(np.asarray(f(*args)), oracle)
                   if check else None)
        sol = speed_of_light_nnz_s(nnz, spmm_bytes(eff, n, n, k,
                                                   idx_bytes=idxb))
        r = Row(f"spmm_banded/{tag}",
                f"n={n},k={k},band=3x{bs},width={S.width}", res, nnz=nnz,
                checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        rows.append(r)
    # spmv on the same structure (strip matvec)
    fv = jax.jit(spmv_reference)
    res = bench_fn_slope(fv, S, x, iters=6, perturb_max_bytes=1 << 20)
    checked = (relative_check(np.asarray(fv(S, x)),
                              dense.astype(np.float64) @ np.asarray(x))
               if check else None)
    sol = speed_of_light_nnz_s(
        nnz, spmv_csr_bytes(S.strips.size, n, n, idx_bytes=0))
    r = Row("spmm_banded/strip-spmv", f"n={n},band=3x{bs},width={S.width}",
            res, nnz=nnz, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    rows.append(_dense_race_row("spmm_banded", dense, X, nnz))
    return rows


@registry.register("bsr")
def bench_bsr(check=True, n=2048, block=(8, 8), density=0.05, k=128, **kw):
    rng = np.random.default_rng(3)
    # block-structured sparsity: dense blocks at `density` of block slots
    nb = n // block[0]
    mask = rng.random((nb, n // block[1])) < density
    dense = (
        np.kron(mask, np.ones(block)).astype(np.float32)
        * gen_matrix_random(rng, n, n)
    )
    A = csr_to_bsr(CSR.fromdense(dense), block_shape=block)
    x = jnp.asarray(gen_matrix_random(rng, n, 1)[:, 0])
    X = jnp.asarray(gen_matrix_random(rng, n, k))
    rows = []
    # encode-once convention: close over the CONCRETE container
    f1 = jax.jit(lambda v: spmv(A, v))
    res = bench_fn_slope(f1, x, iters=6, perturb_max_bytes=1 << 20)
    chk = relative_check(np.asarray(f1(x)), dense @ np.asarray(x)) if check else None
    sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n, idx_bytes=4 / (block[0] * block[1])))
    r = Row("bsr/spmv", f"n={n},b={block},d={density}", res, nnz=A.nnz, checked=chk)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    f2 = jax.jit(lambda a, m: spmm(a, m, method="sparse"))
    res = bench_fn_slope(f2, A, X, iters=6, perturb_max_bytes=1 << 20)
    chk = (
        relative_check(np.asarray(f2(A, X)), dense.astype(np.float64) @ np.asarray(X))
        if check
        else None
    )
    sol = speed_of_light_nnz_s(A.nnz, spmm_bytes(A.nnz, n, n, k, idx_bytes=0))
    r = Row("bsr/spmm", f"n={n},b={block},k={k}", res, nnz=A.nnz, checked=chk)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    # zero-hint auto dispatch: small dense-enough blocks reroute to one
    # cached dense contraction
    f2a = jax.jit(lambda m: spmm(A, m, method="auto"))
    res = bench_fn_slope(f2a, X, iters=6, perturb_max_bytes=1 << 20)
    chk = (
        relative_check(np.asarray(f2a(X)),
                       dense.astype(np.float64) @ np.asarray(X))
        if check
        else None
    )
    r = Row("bsr/spmm-auto", f"n={n},b={block},k={k}", res, nnz=A.nnz,
            checked=chk)
    r.sol_frac = r.nnz_per_s / sol
    rows.append(r)
    return rows


@registry.register("csr_spmv_xl")
def bench_csr_spmv_xl(check=True, n=32768, nnz_row=512, **kw):
    """The 10⁷-nnz scale point (north star: 10⁷–10⁸ nnz): built sparse
    end-to-end (no dense temporaries), oracle via scipy."""
    import scipy.sparse as sps

    # direct generation (scipy.sparse.random's no-replacement sampler is
    # pathologically slow at 10^7+ nnz): fixed draws per row, duplicates
    # merged by the COO→CSR conversion
    g = np.random.default_rng(9)
    rows_ = np.repeat(np.arange(n), nnz_row)
    cols_ = g.integers(0, n, n * nnz_row)
    data_ = g.uniform(-1000, 1000, n * nnz_row).astype(np.float32)
    sp = sps.coo_matrix((data_, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A = CSR.from_scipy(sp)
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    xj = jnp.asarray(x)
    f = jax.jit(lambda a, v: spmv(a, v))
    # VALUE CHAIN (y ← A·y, rescaled): `_looped`-style perturbation would
    # rewrite the whole data plane each step and overstate the op
    chain_scale = jnp.float32(2.0 ** -20)
    res = bench_chain_slope(lambda y, a: f(a, y) * chain_scale, xj, A,
                            iters=6)
    checked = (relative_check(np.asarray(f(A, xj)),
                              sp.astype(np.float64) @ x)
               if check else None)
    sol = speed_of_light_nnz_s(A.nnz, spmv_csr_bytes(A.nnz, n, n))
    r = Row("csr_spmv_xl/csr-fp32", f"n={n},nnz={A.nnz/1e6:.1f}M", res,
            nnz=A.nnz, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    return [r]


@registry.register("weak_scaling")
def bench_weak_scaling(check=True, **kw):
    """MODELED weak scaling (no multi-chip hardware in this environment):
    per-device collective bytes from the partition geometry
    (parallel/scaling.py, validated on the simulated mesh) + the measured
    single-device CSR SpMV throughput from this run when available."""
    from ..utils.timer import BenchResult
    from ..parallel.scaling import weak_scaling_table

    # calibrate the local-compute term to the CSR SpMV rows of this run
    # (the local compute the distributed SpMV runs)
    measured = None
    basis = "memory roofline"
    for name in ("csr_spmv_xl/csr-fp32", "csr_spmv_large/csr-fp32"):
        for r in registry.rows:
            if r.name == name:
                measured = r.nnz_per_s / 1e9
                basis = f"measured single-device {name}"
                break
        if measured is not None:
            break
    table = weak_scaling_table(8192, 256, ns=[1, 2, 4, 8],
                               measured_single_chip_gnnz=measured)
    rows = []
    for row in table:
        res = BenchResult(mean_ms=row["modeled_step_s"] * 1e3,
                          min_ms=row["modeled_step_s"] * 1e3,
                          compile_ms=0.0, iters=0,
                          extras={"modeled": True})
        r = Row(f"weak_scaling/modeled-{row['n_devices']}dev",
                f"rows={row['rows']},comm={row['comm_bytes_per_device']}B",
                res, nnz=row["nnz"])
        r.extras = {
            "weak_scaling_efficiency": row["weak_scaling_efficiency"],
            "modeled": True,
            "basis": basis,
        }
        rows.append(r)
    return rows


@registry.register("spgemm")
def bench_spgemm(check=True, n=2048, density=0.01, **kw):
    """SpGEMM symbolic (host, seconds) + numeric (device, pairs/s)."""
    import time

    from ..ops.spgemm import spgemm_apply, spgemm_plan

    rng = np.random.default_rng(5)
    da = gen_random_dense_sparse(rng, n, n, density=density)
    db = gen_random_dense_sparse(rng, n, n, density=density)
    A, B = CSR.fromdense(da), CSR.fromdense(db)
    t0 = time.time()
    plan = spgemm_plan(A, B)
    plan_s = time.time() - t0
    f = jax.jit(lambda p, ad, bd: spgemm_apply(p, ad, bd).data)
    res = bench_fn_slope(f, plan, A.data, B.data, iters=6)
    checked = None
    if check:
        got = np.asarray(f(plan, A.data, B.data))
        import scipy.sparse as sps

        want = (sps.csr_matrix(da.astype(np.float64))
                @ sps.csr_matrix(db.astype(np.float64))).tocsr()
        want.sort_indices()
        checked = relative_check(got[: plan.c_nnz], want.data)
    # traffic: read both operand data planes + pair indices, write C
    bytes_moved = plan.n_pairs * (2 * 4 + 3 * 4) + plan.c_nnz * 4
    sol = speed_of_light_nnz_s(plan.n_pairs, bytes_moved)
    r = Row("spgemm/numeric", f"n={n},d={density},pairs={plan.n_pairs}",
            res, nnz=plan.n_pairs, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    r.extras = {"plan_seconds": plan_s, "c_nnz": plan.c_nnz}
    rows = [r]
    # CSC output: C^T as CSR, the product Bᵀ @ Aᵀ
    from ..ops.spgemm import spgemm as spgemm_op

    Bt, At = B.transpose(), A.transpose()
    plan_t = spgemm_plan(Bt, At)
    res = bench_fn_slope(f, plan_t, Bt.data, At.data, iters=6)
    checked = None
    if check:
        wantT = want.T.tocsr()
        wantT.sort_indices()
        got = np.asarray(spgemm_op(A, B, method="sparse", output="csc").data)
        checked = relative_check(got[: plan_t.c_nnz], wantT.data)
    r2 = Row("spgemm/numeric-csc", f"n={n},d={density},pairs={plan.n_pairs}",
             res, nnz=plan.n_pairs, checked=checked)
    r2.sol_frac = r2.nnz_per_s / sol
    rows.append(r2)

    # density-adaptive path: full dense product (+ optional pattern
    # extraction) — above the crossover density it beats any gather-bound
    # pair program
    from ..formats import Dense
    from ..ops.spgemm import spgemm_densify, spgemm_extract

    Ad, Bd = Dense.from_sparse(A), Dense.from_sparse(B)
    fd = jax.jit(lambda a, b: spgemm_densify(a, b).data)
    res = bench_fn_slope(fd, Ad, Bd, iters=6)
    checked = None
    if check:
        got = np.asarray(fd(Ad, Bd))
        wr, wc = want.nonzero()
        checked = relative_check(got[wr, wc], np.asarray(want[wr, wc]).ravel())
    r3 = Row("spgemm/densify", f"n={n},d={density},pairs={plan.n_pairs}",
             res, nnz=plan.n_pairs, checked=checked)
    r3.sol_frac = r3.nnz_per_s / sol
    rows.append(r3)

    fe = jax.jit(lambda a, b, p: spgemm_extract(p, spgemm_densify(a, b)).data)
    res = bench_fn_slope(fe, Ad, Bd, plan, iters=6)
    checked = None
    if check:
        got = np.asarray(fe(Ad, Bd, plan))
        checked = relative_check(got[: plan.c_nnz], want.data)
    r4 = Row("spgemm/densify-extract",
             f"n={n},d={density},pairs={plan.n_pairs}",
             res, nnz=plan.n_pairs, checked=checked)
    r4.sol_frac = r4.nnz_per_s / sol
    rows.append(r4)

    return rows


@registry.register("spgemm_xl")
def bench_spgemm_xl(check=True, n=16384, density=0.001, **kw):
    """SpGEMM at a scale where densify is off the auto table (the n²
    dense product is 1 GB fp32): the pair program, raced against the
    dense product.  Dense steps are ~50-200 ms, far above dispatch
    jitter, so min-of-3 direct timing is reliable there."""
    import time

    import scipy.sparse as sps

    from ..ops.spgemm import spgemm_apply, spgemm_plan
    from ..utils.timer import BenchResult

    rng = np.random.default_rng(7)
    sa = sps.random(n, n, density=density, random_state=7, format="csr",
                    dtype=np.float32)
    sb = sps.random(n, n, density=density, random_state=8, format="csr",
                    dtype=np.float32)
    sa.data = rng.uniform(-1000, 1000, sa.nnz).astype(np.float32)
    sb.data = rng.uniform(-1000, 1000, sb.nnz).astype(np.float32)
    A, B = CSR.from_scipy(sa), CSR.from_scipy(sb)
    want = None
    if check:
        want = (sa.astype(np.float64) @ sb.astype(np.float64)).tocsr()
        want.sort_indices()
    t0 = time.time()
    plan = spgemm_plan(A, B)
    plan_s = time.time() - t0
    f = jax.jit(lambda p, ad, bd: spgemm_apply(p, ad, bd).data)
    res = bench_fn_slope(f, plan, A.data, B.data, iters=6)
    checked = (relative_check(np.asarray(f(plan, A.data, B.data))
                              [: plan.c_nnz], want.data)
               if check else None)
    n_pairs = plan.n_pairs
    sol = speed_of_light_nnz_s(
        n_pairs, n_pairs * (2 * 4 + 3 * 4) + plan.c_nnz * 4)
    r = Row("spgemm_xl/pairs", f"n={n},d={density},pairs={n_pairs}", res,
            nnz=n_pairs, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    r.extras = {"plan_seconds": plan_s, "c_nnz": plan.c_nnz}
    rows = [r]
    for tag, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        ad = jnp.asarray(sa.toarray()).astype(dt)
        bd = jnp.asarray(sb.toarray()).astype(dt)
        fd = jax.jit(lambda a, b: jnp.dot(
            a, b, precision=matmul_precision(a.dtype)))
        fd(ad, bd).block_until_ready()  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fd(ad, bd).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        res = BenchResult(mean_ms=best * 1e3, min_ms=best * 1e3,
                          compile_ms=0.0, iters=3, extras={})
        checked = None
        if check:
            # compare on C's sparse pattern (the dense zeros are trivial)
            got = np.asarray(fd(ad, bd)).astype(np.float64)
            checked = relative_check(got[want.nonzero()], want.data)
        r = Row(f"spgemm_xl/dense-race-{tag}", f"n={n},2n^3 dense", res,
                nnz=n_pairs, checked=checked)
        rows.append(r)
        del ad, bd
    return rows


@registry.register("spgemm_crossover")
def bench_spgemm_crossover(check=True, **kw):
    """Density-crossover study: the pair program vs densify across (n, d)
    points between the spgemm (n=2048) and spgemm_xl (n=16384) anchors.
    The spgemm(method='auto') rule's constants are read against these
    rows (ops/spgemm.py: _DENSE_FLOPS_PER_S / _PAIRS_PER_S)."""
    import scipy.sparse as sps

    from ..ops.spgemm import spgemm_apply, spgemm_densify, spgemm_plan

    rows = []
    for n, density in ((4096, 0.004), (8192, 0.002)):
        rng = np.random.default_rng(11)
        sa = sps.random(n, n, density=density, random_state=11,
                        format="csr", dtype=np.float32)
        sb = sps.random(n, n, density=density, random_state=12,
                        format="csr", dtype=np.float32)
        sa.data = rng.uniform(-1000, 1000, sa.nnz).astype(np.float32)
        sb.data = rng.uniform(-1000, 1000, sb.nnz).astype(np.float32)
        A, B = CSR.from_scipy(sa), CSR.from_scipy(sb)
        want = None
        if check:
            want = (sa.astype(np.float64) @ sb.astype(np.float64)).tocsr()
            want.sort_indices()
        plan = spgemm_plan(A, B)
        fp = jax.jit(lambda p, ad, bd: spgemm_apply(p, ad, bd).data)
        res = bench_fn_slope(fp, plan, A.data, B.data, iters=6)
        checked = (relative_check(np.asarray(fp(plan, A.data, B.data))
                                  [: plan.c_nnz], want.data)
                   if check else None)
        n_pairs = plan.n_pairs
        sol = speed_of_light_nnz_s(
            n_pairs, n_pairs * (2 * 4 + 3 * 4) + plan.c_nnz * 4)
        r = Row("spgemm_crossover/pairs",
                f"n={n},d={density},pairs={n_pairs}", res, nnz=n_pairs,
                checked=checked)
        r.sol_frac = r.nnz_per_s / sol
        rows.append(r)
        fdn = jax.jit(lambda a, b: spgemm_densify(a, b).data)
        res = bench_fn_slope(fdn, A, B, iters=6, perturb_max_bytes=1 << 20)
        checked = None
        if check:
            got = np.asarray(fdn(A, B))
            checked = relative_check(got[want.nonzero()], want.data)
        r = Row("spgemm_crossover/densify",
                f"n={n},d={density},pairs={n_pairs}", res, nnz=n_pairs,
                checked=checked)
        rows.append(r)
    return rows


@registry.register("trisolve")
def bench_trisolve(check=True, n=4096, nnz_row=8, **kw):
    """Level-scheduled triangular solve (rows/s through the level scan)."""
    import scipy.sparse as sps

    from ..ops.trisolve import trisolve_apply, trisolve_plan

    rng = np.random.default_rng(6)
    # lower-triangular with short dependency chains (random DAG depth)
    d = sps.random(n, n, density=nnz_row / n, random_state=6,
                   format="csr", dtype=np.float32)
    L = sps.tril(d, k=-1).tocsr() + sps.eye(n, format="csr", dtype=np.float32) * 4.0
    A = CSR.from_scipy(L.tocsr())
    plan = trisolve_plan(A, lower=True)
    b = jnp.asarray(gen_matrix_random(rng, n, 1)[:, 0])
    f = jax.jit(lambda p, v: trisolve_apply(p, v))
    res = bench_fn_slope(f, plan, b, iters=6, perturb_max_bytes=1 << 20)
    checked = None
    if check:
        import scipy.sparse.linalg as spla

        want = spla.spsolve_triangular(L.tocsr().astype(np.float64),
                                       np.asarray(b), lower=True)
        checked = relative_check(np.asarray(f(plan, b)), want)
    nnz = int(L.nnz)
    sol = speed_of_light_nnz_s(nnz, spmv_csr_bytes(nnz, n, n))
    r = Row("trisolve/level-sched",
            f"n={n},nnz={nnz},levels={plan.rows.shape[0]}",
            res, nnz=nnz, checked=checked)
    r.sol_frac = r.nnz_per_s / sol
    rows = [r]

    # fixed-point formulation: n_levels-1 CSR SpMVs of E
    from ..ops.trisolve import trisolve_fixpoint_apply, trisolve_fixpoint_plan

    fplan = trisolve_fixpoint_plan(A, lower=True)
    ff = jax.jit(trisolve_fixpoint_apply)
    res2 = bench_fn_slope(ff, fplan, b, iters=6, perturb_max_bytes=1 << 20)
    checked2 = None
    if check:
        checked2 = relative_check(np.asarray(ff(fplan, b)), want)
    r2 = Row("trisolve/fixpoint", f"n={n},nnz={nnz},iters={fplan.n_iters}",
             res2, nnz=nnz, checked=checked2)
    r2.sol_frac = r2.nnz_per_s / sol
    rows.append(r2)

    # the banded regime (Poisson ILU(0) L factor — every preconditioned
    # solver's inner loop), on the level scan
    import time as _t

    from ..ops.ilu import ilu0

    side = int(np.sqrt(n))
    _, Apo = _poisson2d(side * side)
    Lf, _ = ilu0(CSR.from_scipy(Apo.astype(np.float32)))
    nnz_l = Lf.nnz
    bl = jnp.asarray(gen_matrix_random(rng, side * side, 1)[:, 0])
    t0 = _t.time()
    lplan = trisolve_plan(Lf, lower=True, unit_diagonal=True)
    plan_s = _t.time() - t0
    res3 = bench_fn_slope(f, lplan, bl, iters=6, perturb_max_bytes=0)
    checked3 = None
    if check:
        import scipy.sparse.linalg as spla

        Ld = Lf.to_scipy().astype(np.float64).tolil()
        Ld.setdiag(1.0)
        want_l = spla.spsolve_triangular(Ld.tocsr(), np.asarray(bl),
                                         lower=True)
        checked3 = relative_check(np.asarray(f(lplan, bl)), want_l)
    r3 = Row("trisolve/level-ilu",
             f"n={side * side},nnz={nnz_l},levels={lplan.rows.shape[0]}",
             res3, nnz=nnz_l, checked=checked3)
    r3.sol_frac = r3.nnz_per_s / speed_of_light_nnz_s(
        nnz_l, spmv_csr_bytes(nnz_l, side * side, side * side))
    r3.extras = {"plan_seconds": plan_s}
    rows.append(r3)
    return rows


def _poisson2d(n, eps=1.0):
    """5-point Laplacian on a √n×√n grid (anisotropic for eps != 1);
    returns (n_actual, scipy CSR)."""
    import scipy.sparse as sps

    side = int(np.sqrt(n))
    n = side * side
    Iq = sps.eye(side)
    if eps == 1.0:
        T = sps.diags([-1, 4, -1], [-1, 0, 1], (side, side))
        Apo = (sps.kron(Iq, T) + sps.kron(sps.diags([-1, -1], [-1, 1],
                                                    (side, side)),
                                          Iq)).tocsr()
    else:
        Tx = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (side, side))
        Apo = (sps.kron(Iq, Tx) + eps * sps.kron(Tx, Iq)).tocsr()
    return n, Apo


def _bench_cg_to_tol(check, n, iters, tol, maxiter, group_name,
                     eps=1.0, variant_names=None):
    """Preconditioned CG on the 2-D Poisson system: per-iteration slope
    time × measured iterations-to-tolerance = wall-clock to ‖r‖/‖b‖ ≤ tol
    (the number that decides whether preconditioning wins end-to-end).

    ``eps``: anisotropy ratio of the 5-point operator (−u_xx − eps·u_yy).
    eps=1 is the isotropic system; stiff anisotropy multiplies plain CG's iteration count
    (12×/32× at eps=100/1000) while IC(0)'s stays flat — the regime
    where the factored preconditioners can win end-to-end."""
    import time

    import scipy.sparse as sps

    from ..ops.ichol import ic0_plans, ic_apply
    from ..ops.ilu import ilu0_fixpoint_plans, ilu0_plans, ilu_apply
    from ..solvers import cg

    n, Apo = _poisson2d(n, eps)
    A = CSR.from_scipy(Apo.astype(np.float32).tocsr())
    rng = np.random.default_rng(8)
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    b_norm = float(np.linalg.norm(np.asarray(b)))
    from ..ops.spmv import prepare_spmv

    Ap = prepare_spmv(A)

    def _mk(builder, apply_):
        t0 = time.time()
        plans = builder()
        return (lambda r: apply_(plans, r)), time.time() - t0

    builders = {
        # truncated Neumann: 6 CSR SpMVs per triangle (approximate)
        "ilu0-fix6": (lambda: ilu0_fixpoint_plans(A, n_iters=6), ilu_apply),
        # exact level-scheduled solves
        "ilu0-level": (lambda: ilu0_plans(A), ilu_apply),
        "ic0-level": (lambda: ic0_plans(A), ic_apply),
    }
    if variant_names is None:
        variant_names = ("ilu0-fix6", "ilu0-level", "ic0-level")
    variants = [("plain", None, 0.0)]
    for name in variant_names:
        bld, apply_ = builders[name]
        M, s = _mk(bld, apply_)
        variants.append((name, M, s))

    rows = []
    plain_iters = None
    plain_ms_to_tol = None
    for label, precond, pack_s in variants:
        # per-iteration time: fixed-work solve (tol=0 → exactly `iters`)
        f = jax.jit(lambda bb: cg(Ap, bb, maxiter=iters, M=precond,
                                  tol=0.0).x)
        res = bench_fn_slope(f, b, iters=4, inner_lo=2, inner_hi=10)
        per_iter_ms = res.min_ms / iters
        # iterations to tolerance (recurrence residual, jitted solve)
        ft = jax.jit(lambda bb: cg(Ap, bb, maxiter=maxiter, M=precond,
                                   tol=tol))
        sol_res = ft(b)
        iters_tol = int(sol_res.iters)
        reached = bool(float(sol_res.residual) <= tol * b_norm * 1.001
                       and iters_tol < maxiter)
        ms_to_tol = per_iter_ms * iters_tol
        checked = None
        true_res = None
        if check:
            x = np.asarray(sol_res.x)
            true_res = float(np.linalg.norm(Apo @ x - np.asarray(b)))
            # tight: the tol run must actually reach tol (recurrence) and
            # the TRUE residual must confirm within a 10x fp32 margin;
            # preconditioned runs must converge in ≤ 0.6x plain's iters
            checked = bool(reached and true_res <= 10 * tol * b_norm)
            if label != "plain" and plain_iters is not None:
                checked = checked and iters_tol <= 0.6 * plain_iters
        if label == "plain":
            plain_iters = iters_tol
            plain_ms_to_tol = ms_to_tol
        nnz = A.nnz * iters
        r = Row(f"{group_name}/{label}",
                f"n={n},iters={iters},tol={tol:g}", res, nnz=nnz,
                checked=checked)
        sol = speed_of_light_nnz_s(nnz, spmv_csr_bytes(nnz, n, n))
        r.sol_frac = r.nnz_per_s / sol
        r.extras = {"per_iter_ms": per_iter_ms, "iters_to_tol": iters_tol,
                    "ms_to_tol": ms_to_tol, "reached_tol": reached,
                    "pack_seconds": pack_s}
        if label != "plain" and plain_ms_to_tol is not None:
            # the break-even: how many
            # solves of THIS system pay back the preconditioner setup
            saved_s = (plain_ms_to_tol - ms_to_tol) / 1e3
            r.extras["solves_to_amortize"] = (
                round(pack_s / saved_s, 1) if saved_s > 0 else float("inf"))
        if true_res is not None:
            r.extras["true_rel_residual"] = true_res / b_norm
        rows.append(r)
    return rows


@registry.register("ilu_cg")
def bench_ilu_cg(check=True, n=4096, iters=25, tol=1e-6, maxiter=3000,
                 **kw):
    """End-to-end preconditioned solve at n=4096: per-iteration slope +
    wall-clock to ‖r‖/‖b‖ ≤ 1e-6 for plain/fixpoint/level CG."""
    return _bench_cg_to_tol(check, n, iters, tol, maxiter, "ilu_cg")


@registry.register("ilu_cg_xl")
def bench_ilu_cg_xl(check=True, n=65536, iters=25, tol=1e-5,
                    maxiter=6000, **kw):
    """The 65k Poisson point.  tol=1e-5: at this size the fp32
    recurrence reaches 1e-6 but the TRUE residual floor sits near
    4e-6·‖b‖, so 1e-6 cannot be confirmed — the bench pins the tightest
    tolerance fp32 can certify."""
    return _bench_cg_to_tol(check, n, iters, tol, maxiter, "ilu_cg_xl")


@registry.register("spmm_xl")
def bench_spmm_xl(check=True, n=32768, k=32, **kw):
    """XL multi-RHS regime map: CSR spmm (gather + segment-sum) against
    the pre-densified bf16 product at mid degree, and the sliced-ELL
    row-gather layout at ~2 entries/row."""
    import scipy.sparse as sps

    from ..ops.spmm_lowdeg import pack_sliced_ell, spmm_sliced_ell

    rng = np.random.default_rng(6)
    rows = []
    for nnz_row in (64, 507):
        d = nnz_row / n
        sp = sps.random(n, n, density=d, random_state=5, format="csr",
                        dtype=np.float32)
        sp.data = rng.uniform(-1, 1, sp.nnz).astype(np.float32)
        A = CSR.from_scipy(sp)
        X = jnp.asarray(rng.uniform(-1, 1, (n, k)), np.float32)
        want = None
        if check:
            want = sp.astype(np.float64) @ np.asarray(X, np.float64)
        f = jax.jit(lambda x, a: spmm(a, x, method="sparse"))
        res = bench_fn_slope(f, X, A, iters=4, inner_lo=2, inner_hi=10,
                             perturb_max_bytes=1 << 20)
        checked = (relative_check(np.asarray(f(X, A)), want)
                   if check else None)
        r = Row("spmm_xl/csr", f"n={n},k={k},nnz/row={nnz_row}", res,
                nnz=sp.nnz, checked=checked)
        r.sol_frac = r.nnz_per_s / speed_of_light_nnz_s(
            sp.nnz, spmm_bytes(sp.nnz, n, n, k))
        rows.append(r)
        # pre-dense bf16 race: the streaming-bound alternative
        ad = jnp.asarray(sp.toarray(), jnp.bfloat16)
        fd = jax.jit(lambda a, x: (a @ x.astype(jnp.bfloat16)).astype(
            jnp.float32))
        res = bench_fn_slope(fd, ad, X, iters=4, inner_lo=2, inner_hi=10,
                             perturb_max_bytes=1 << 20)
        checked = None
        if check:
            from ..utils.testutils import quantized_check

            checked = quantized_check(np.asarray(fd(ad, X)), want)
        r = Row("spmm_xl/pre-dense-bf16", f"n={n},k={k},nnz/row={nnz_row}",
                res, nnz=sp.nnz, checked=checked)
        rows.append(r)
        del ad
    # low-degree XL point: ~2 entries/row through the sliced-ELL layout
    nnz_row = 2
    g2 = np.random.default_rng(12)
    rows_ = np.repeat(np.arange(n), nnz_row)
    cols_ = g2.integers(0, n, rows_.size)
    data_ = g2.uniform(-1, 1, rows_.size).astype(np.float32)
    sp = sps.coo_matrix((data_, (rows_, cols_)), shape=(n, n)).tocsr()
    sp.sum_duplicates()
    A = CSR.from_scipy(sp)
    X = jnp.asarray(g2.uniform(-1, 1, (n, k)), np.float32)
    want = sp.astype(np.float64) @ np.asarray(X, np.float64) if check \
        else None
    pk_s = pack_sliced_ell(A)
    fse = jax.jit(spmm_sliced_ell)
    res = bench_fn_slope(fse, pk_s, X, iters=6, perturb_max_bytes=1 << 20)
    checked = (relative_check(np.asarray(fse(pk_s, X)), want)
               if check else None)
    r = Row("spmm_xl/sliced-ell",
            f"n={n},k={k},nnz/row={nnz_row},segs={len(pk_s.vals)},"
            f"fill={pk_s.fill_rate:.2f}",
            res, nnz=sp.nnz, checked=checked)
    # bytes for the row-gather algorithm: each entry drags a k-float X row
    # (÷ fill for segment padding) + X read + Y write
    bytes_moved = sp.nnz * k * 4 / max(pk_s.fill_rate, 1e-6) + n * k * 8
    r.sol_frac = r.nnz_per_s / speed_of_light_nnz_s(sp.nnz, bytes_moved)
    rows.append(r)
    return rows


@registry.register("block_cg_xl")
def bench_block_cg_xl(check=True, n=65536, k=8, iters=25, tol=1e-5,
                      maxiter=4000, **kw):
    """Multi-RHS XL regime: does preconditioning pay when k systems solve
    at once?  Plain block CG turns the SpMV into an SpMM (one matrix
    stream serves k columns) and the IC(0) solve runs k columns through
    one vmapped level scan — so the ms-to-tol race, not either side's
    speedup, decides.  The seq-plain-x{k} row is the do-nothing baseline:
    k independent single-RHS plain CG solves."""
    import time

    from ..ops.ichol import ic0_plans, ic_apply
    from ..ops.spmv import prepare_spmv
    from ..solvers import cg
    from ..solvers.block import block_cg

    n, Apo = _poisson2d(n)
    A = CSR.from_scipy(Apo.astype(np.float32).tocsr())
    rng = np.random.default_rng(9)
    B = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    bnorm = np.linalg.norm(np.asarray(B), axis=0)
    S = A  # matmat: CSR spmm (gather + segment-sum over k columns)

    rows = []
    # seq-plain baseline: single-RHS plain CG on the auto pack, scaled ×k
    # (matrices/plans travel as jit ARGUMENTS — closed-over they get
    # baked into the HLO as constants)
    Ap = prepare_spmv(A)
    f1 = jax.jit(lambda bb, q: cg(q, bb, maxiter=iters, tol=0.0).x)
    res1 = bench_fn_slope(f1, B[:, 0], Ap, iters=4, inner_lo=2, inner_hi=10)
    sol1 = jax.jit(lambda bb, q: cg(q, bb, maxiter=maxiter, tol=tol))(
        B[:, 0], Ap)
    it1 = int(sol1.iters)
    per1 = res1.min_ms / iters
    from ..utils.timer import BenchResult

    r = Row(f"block_cg_xl/seq-plain-x{k}", f"n={n},k={k},tol={tol:g}",
            BenchResult(mean_ms=per1 * iters * k, min_ms=per1 * iters * k,
                        compile_ms=0.0, iters=res1.iters, extras={}),
            nnz=A.nnz * iters * k,
            checked=bool(float(sol1.residual) <= tol * bnorm[0] * 1.001)
            if check else None)
    r.sol_frac = None
    r.extras = {"per_iter_ms": per1 * k, "iters_to_tol": it1,
                "ms_to_tol": per1 * it1 * k}
    rows.append(r)

    t0 = time.time()
    plans = ic0_plans(A)
    pack_s = time.time() - t0
    variants = [("block-plain", None, 0.0),
                ("block-ic0-level", True, pack_s)]
    for label, M, ps in variants:
        use_M = M is not None

        def _mk(maxit, tl):
            @jax.jit
            def run(bb, Sq, pl):
                mm = lambda V: spmm(Sq, V, method="sparse")
                Mf = (lambda R: ic_apply(pl, R)) if use_M else None
                return block_cg(mm, bb, maxiter=maxit, tol=tl, M=Mf)

            return run

        f = lambda bb, Sq, pl, run=_mk(iters, 0.0): run(bb, Sq, pl).x
        res = bench_fn_slope(f, B, S, plans, iters=4, inner_lo=2,
                             inner_hi=10)
        per_iter_ms = res.min_ms / iters
        sol = _mk(maxiter, tol)(B, S, plans)
        iters_tol = int(sol.iters)
        reached = bool(
            np.all(np.asarray(sol.residuals) <= tol * bnorm * 1.001)
            and iters_tol < maxiter)
        checked = None
        if check:
            X = np.asarray(sol.x)
            true_res = np.linalg.norm(Apo @ X - np.asarray(B), axis=0)
            checked = bool(reached and np.all(true_res <= 10 * tol * bnorm))
        r = Row(f"block_cg_xl/{label}", f"n={n},k={k},tol={tol:g}", res,
                nnz=A.nnz * iters * k, checked=checked)
        r.sol_frac = None
        r.extras = {"per_iter_ms": per_iter_ms, "iters_to_tol": iters_tol,
                    "ms_to_tol": per_iter_ms * iters_tol,
                    "reached_tol": reached, "pack_seconds": ps}
        rows.append(r)
    return rows


@registry.register("ilu_cg_aniso")
def bench_ilu_cg_aniso(check=True, n=65536, iters=25, tol=1e-5,
                       maxiter=12000, eps=1000.0, **kw):
    """The preconditioner's favourable case: stiff anisotropic Poisson
    (−u_xx − 1000·u_yy).  Plain CG's iteration count blows up ~32× while
    IC(0)'s stays flat (counted on the CPU oracle), so a per-iteration
    premium can be paid for."""
    return _bench_cg_to_tol(check, n, iters, tol, maxiter, "ilu_cg_aniso",
                            eps=eps, variant_names=("ic0-level",))


@registry.register("codebook_gemm")
def bench_codebook_gemm(check=True, density=0.25, **kw):
    """The reference's own benchmark: sparse AddMatMat at its default shape
    (blas_test.cc:32, blas_test.h:216-252), at the CLI-provided ref_m/n/k.
    Variants: CodebookCSR auto (cached dense index plane + dequant dot),
    forced segment-sum, XLA dequant (fp32/bf16), and int8/int16 GEMMs."""
    m = kw.get("ref_m", REF_M)
    n = kw.get("ref_n", REF_N)
    k = kw.get("ref_k", REF_K)
    from ..formats import CodebookDense
    from ..ops import add_mat_mat_int8, quantize_codebook, spmm

    rng = np.random.default_rng(4)
    a = jnp.asarray(gen_matrix_random(rng, m, k))
    c = jnp.asarray(gen_matrix_random(rng, m, n))
    idx_mtx, table = gen_sparse_index_matrix(rng, k, n, density=density,
                                             table_size=255)
    b_csr = CodebookCSR.from_index_matrix(idx_mtx, table, trans=True)
    b_dns = CodebookDense.from_index_matrix(idx_mtx, table, trans=True)
    b_dense_np = np.asarray(b_csr.todense()).T.astype(np.float64)
    oracle = np.asarray(c) + np.asarray(a).astype(np.float64) @ b_dense_np
    # the bf16 variant is a quantized path: its error is ~0.4 % of the
    # OUTPUT SCALE (operand rounding), which a per-element relative policy
    # cannot express at cancellation points — judge it against the fp64
    # oracle with a scale-floored denominator instead

    def _bf16_check(got):
        scale = np.abs(oracle).max()
        rel = np.abs(got - oracle) / (np.abs(oracle) + 0.02 * scale)
        return bool(np.median(rel) < 0.02 and np.quantile(rel, 0.99) < 0.1)

    def _int8_check(got):
        # per-tensor symmetric int8 on both operands: ~0.8 % per-operand
        # grid error, judged on the same scale-floored basis
        scale = np.abs(oracle).max()
        rel = np.abs(got - oracle) / (np.abs(oracle) + 0.02 * scale)
        return bool(np.median(rel) < 0.04 and np.quantile(rel, 0.99) < 0.2)

    rows = []
    # the weights are encode-once constants (the reference's whole design,
    # sparse-matrix.cc:21 vs :140) — so each variant CLOSES OVER its
    # container: the eager-dispatch conveniences (auto conversion, packing
    # caches) see the concrete object even while a/c stay jitted inputs
    all_variants = {
        "csr-auto": jax.jit(
            lambda aa, cc: add_mat_mat(aa, b_csr, cc, 1.0, 1.0)),
        "csr-segsum": jax.jit(
            lambda aa, cc: cc + spmm(b_csr, aa.T, method="sparse").T),
        "dense-dequant": jax.jit(
            lambda aa, cc: cc + spmm_densify(b_dns, aa.T).T),
        # bf16 dequant: the dense-dequant path is memory-bound (~20 MB at
        # fp32), so dequantizing the LUT to bf16 halves the dominant
        # B-materialization traffic; judged by the quantized-oracle check
        "dense-dequant-bf16": jax.jit(
            lambda aa, cc: cc + jnp.dot(
                aa.astype(jnp.bfloat16),
                b_dns.val_table.astype(jnp.bfloat16)[
                    b_dns.idx.astype(jnp.int32)].T,
            ).astype(jnp.float32)),
    }

    def _int8_variant():
        # int8 activations x int8 codebook on the integer path —
        # the analogue of the fork-only cblas_wgemm_plus
        # (reference openblas_darwin_plus/include/cblas.h:252-257);
        # quantized lazily so unrelated headline runs don't pay the encode
        b_q = quantize_codebook(b_dns)
        return jax.jit(lambda aa, cc: add_mat_mat_int8(aa, b_q, cc, 1.0, 1.0))

    all_variants["int8-gemm"] = _int8_variant

    def _int16_variant():
        # int16 activations (the exact cblas_wgemm_plus signature,
        # cblas.h:252-257): hi/lo byte-split double-pump of the int8 GEMM
        # (ops/quantized.py add_mat_mat_int16) — 2 integer passes for a
        # 256x finer activation grid; residual error is the int8 TABLE
        # quantization, so it is judged at the bf16-grade tolerance
        from ..ops.quantized import add_mat_mat_int16

        b_q = quantize_codebook(b_dns)
        return jax.jit(
            lambda aa, cc: add_mat_mat_int16(aa, b_q, cc, 1.0, 1.0))

    all_variants["int16-gemm"] = _int16_variant
    names = kw.get("variants") or ("csr-auto", "dense-dequant",
                                   "dense-dequant-bf16", "int8-gemm",
                                   "int16-gemm")
    for vname in names:
        f = all_variants[vname]
        if vname in ("int8-gemm", "int16-gemm"):
            f = f()  # lazy factory
        name = f"codebook_gemm/{vname}"
        res = bench_fn_slope(f, a, c, iters=8)
        if not check:
            checked = None
        elif vname.endswith("bf16"):
            checked = _bf16_check(np.asarray(f(a, c)))
        elif vname == "int8-gemm":
            checked = _int8_check(np.asarray(f(a, c)))
        elif vname == "int16-gemm":
            checked = _bf16_check(np.asarray(f(a, c)))
        else:
            checked = relative_check(np.asarray(f(a, c)), oracle)
        r = Row(name, f"m={m},n={n},k={k},d={density}", res, nnz=b_csr.nnz,
                checked=checked)
        r.extras = {"vs_baseline": REF_BASELINE_MS / res.min_ms}
        rows.append(r)
    # the honesty race the reference always runs (blas_test.cc:41): plain
    # dense GEMM of the same problem on the same device, both precisions
    b_dense32 = jnp.asarray(b_dense_np.astype(np.float32))
    for prec, tag in ((jax.lax.Precision.HIGHEST, "fp32"),
                      (jax.lax.Precision.DEFAULT, "bf16")):
        fd = jax.jit(lambda aa, bb, cc, p=prec: cc + jnp.dot(
            aa, bb, precision=p))
        res = bench_fn_slope(fd, a, b_dense32, c, iters=8,
                             inner_lo=16, inner_hi=144)
        r = Row(f"codebook_gemm/dense-race-{tag}",
                f"m={m},n={n},k={k} dense", res, nnz=b_csr.nnz)
        r.extras = {"vs_baseline": REF_BASELINE_MS / res.min_ms}
        rows.append(r)
    # the reference harness's third lane: PREPACKED dense GEMM
    # (SGEMM_PRE_INVOKER, blas_test.cc:43, blas_test.h:254-290) — operand
    # layout conversion paid once at encode time, the timed call reuses
    # it.  Here: operands pre-cast to bf16 at build; the timed call is
    # one bf16 tensor-core product with fp32 accumulate (vs
    # dense-race-fp32's true-fp32 HIGHEST product).
    a_pre = a.astype(jnp.bfloat16)
    b_pre = b_dense32.astype(jnp.bfloat16)
    fp = jax.jit(lambda aa, bb, cc: cc + jnp.dot(
        aa, bb, preferred_element_type=jnp.float32))
    res = bench_fn_slope(fp, a_pre, b_pre, c, iters=8,
                         inner_lo=16, inner_hi=144)
    checked = _bf16_check(np.asarray(fp(a_pre, b_pre, c))) if check else None
    r = Row("codebook_gemm/dense-race-pre",
            f"m={m},n={n},k={k} prepacked bf16", res, nnz=b_csr.nnz,
            checked=checked)
    r.extras = {"vs_baseline": REF_BASELINE_MS / res.min_ms}
    rows.append(r)
    return rows
