#!/usr/bin/env python
"""Smoke run of the sparse stack on an NVIDIA GPU, checked against plain
references.

    python chip_smoke.py          # one GPU: phases 1-5
    python chip_smoke.py --four   # four GPUs: the distributed phase only

Every phase drives the library through its public entry points at a size
a user would call real, compares the result with a plain reference (scipy
in float64 on the host, or the same op on one device), and prints one
line: op and shape, nnz, the bytes the op must move, the precision, the
error against its tolerance, a host-clock time around
``block_until_ready`` after warm-up (with the card's name and power
limit), and that time's share of the device's memory-bandwidth bound.
A failed check raises; nothing is caught and skipped.  The last line of
standard output is one JSON object naming the device.

There is no CPU fallback: the script exits non-zero when JAX finds no GPU.
One process drives the card (or cards); nvidia-smi runs in a child that
stays off JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np


def card_info() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no card"


@dataclasses.dataclass
class Ctx:
    card: str  # nvidia-smi name and power limit, printed beside each time
    bw: float | None  # device memory bandwidth, bytes/s (None: no bound)
    reps: int = 5


def _timed(ctx: Ctx, fn, *args, reps: int | None = None):
    """(result, seconds): warm-up call, then the min over ``reps`` calls,
    each timed on the host clock around ``block_until_ready``."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps or ctx.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def report(ctx: Ctx, op: str, shape: str, nnz: int, nbytes: int, prec: str,
           err: float, tol: float, seconds: float, reps: int | None = None):
    """Print one phase line; raise if ``err`` exceeds ``tol``."""
    share = ("n/a" if ctx.bw is None or nbytes <= 0
             else f"{nbytes / ctx.bw / seconds:.3f}")
    print(f"[{op}] {shape} | nnz={nnz} bytes={nbytes} | precision={prec} | "
          f"err={err:.3e} tol={tol:.1e} | time={seconds * 1e3:.4f} ms "
          f"(host clock, min of {reps or ctx.reps}) [{ctx.card}] | "
          f"bytes-bound share={share}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{op}: error {err:.3e} exceeds {tol:.1e}")


def scaled_err(got, want, scale, floor: float = 1e-30) -> float:
    """max |got − want| / scale, with ``scale`` the magnitude the error is
    held to (|A||x| for products); entries with scale below ``floor`` are
    held to ``floor``."""
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(scale, floor),
                        initial=0.0))


# ---------------------------------------------------------------------------
# matrices, made from a seed
# ---------------------------------------------------------------------------

def uniform_csr(n: int, per_row: int, seed: int):
    """n×n scipy CSR with ``per_row`` uniformly random columns in each row
    (one per equal column stratum, so no duplicates), values in [-1, 1)."""
    import scipy.sparse as sps

    g = np.random.default_rng(seed)
    stratum = n // per_row
    cols = (np.arange(per_row, dtype=np.int64) * stratum
            + g.integers(0, stratum, size=(n, per_row)))
    data = (g.random(n * per_row, dtype=np.float32) * 2 - 1)
    indptr = np.arange(n + 1, dtype=np.int64) * per_row
    return sps.csr_matrix((data, cols.reshape(-1).astype(np.int32), indptr),
                          shape=(n, n))


def banded_csr(n: int, width: int, seed: int):
    """n×n band of ``width`` diagonals around the main one, values in
    [-1, 1) (a diagonally dominant main diagonal)."""
    import scipy.sparse as sps

    g = np.random.default_rng(seed)
    offs = list(range(-(width // 2), width - width // 2))
    diags = [g.random(n - abs(o), dtype=np.float32) * 2 - 1 for o in offs]
    diags[offs.index(0)] = diags[offs.index(0)] + np.float32(width)
    return sps.diags(diags, offs, shape=(n, n), format="csr",
                     dtype=np.float32)


def poisson2d(side: int):
    """5-point Laplacian on a side×side grid (SPD), float32 CSR."""
    import scipy.sparse as sps

    eye = sps.eye(side, dtype=np.float32)
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (side, side),
                  dtype=np.float32)
    off = sps.diags([-1.0, -1.0], [-1, 1], (side, side), dtype=np.float32)
    return (sps.kron(eye, t) + sps.kron(off, eye)).tocsr().astype(np.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_spmv(ctx: Ctx, n: int = 1 << 20, per_row: int = 32, seed: int = 1):
    """CSR fp32 SpMV through ``spmv`` under jit, against scipy float64;
    plus the same product through jax.experimental.sparse as a race."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from sparsematrix_tpu import CSR, spmv
    from sparsematrix_tpu.utils.roofline import spmv_csr_bytes

    sp = uniform_csr(n, per_row, seed)
    x = np.random.default_rng(seed + 100).random(n, dtype=np.float32) * 2 - 1
    A = CSR.from_scipy(sp)
    xj = jnp.asarray(x)
    y, t = _timed(ctx, jax.jit(spmv), A, xj)
    want = sp.astype(np.float64) @ x.astype(np.float64)
    scale = abs(sp).astype(np.float64) @ np.abs(x).astype(np.float64)
    nbytes = spmv_csr_bytes(sp.nnz, n, n)
    report(ctx, "spmv", f"csr {n}x{n}", sp.nnz, nbytes,
           "fp32 (gather + segment-sum)", scaled_err(y, want, scale), 1e-5, t)

    M = jsparse.CSR((jnp.asarray(sp.data), jnp.asarray(sp.indices),
                     jnp.asarray(sp.indptr.astype(np.int32))), shape=(n, n))
    race = jax.jit(lambda m, v: m @ v)
    hlo = race.lower(M, xj).as_text().lower()
    lowered = "cuSPARSE" if "cusparse" in hlo else "XLA (no cuSPARSE call)"
    yr, tr = _timed(ctx, race, M, xj)
    report(ctx, "spmv-race", f"jax.experimental.sparse CSR {n}x{n} "
           f"lowered to {lowered}", sp.nnz, nbytes, "fp32",
           scaled_err(yr, want, scale), 1e-5, tr)


def phase_spmm(ctx: Ctx, n: int = 1 << 18, per_row: int = 32, k: int = 32,
               band: int = 96, seed: int = 2):
    """CSR fp32 SpMM through ``spmm`` (k dense RHS), and a banded matrix
    of about the same nnz that ``prepare_spmv`` routes to strips."""
    import jax
    import jax.numpy as jnp

    from sparsematrix_tpu import CSR, spmm
    from sparsematrix_tpu.formats import StripDense
    from sparsematrix_tpu.ops import prepare_spmv
    from sparsematrix_tpu.utils.roofline import spmm_bytes

    g = np.random.default_rng(seed + 100)
    f = jax.jit(spmm)
    sp = uniform_csr(n, per_row, seed)
    X = g.random((n, k), dtype=np.float32) * 2 - 1
    Y, t = _timed(ctx, f, CSR.from_scipy(sp), jnp.asarray(X))
    want = sp.astype(np.float64) @ X.astype(np.float64)
    scale = abs(sp).astype(np.float64) @ np.abs(X).astype(np.float64)
    report(ctx, "spmm", f"csr {n}x{n} @ {n}x{k}", sp.nnz,
           spmm_bytes(sp.nnz, n, n, k), "fp32 (gather + segment-sum)",
           scaled_err(Y, want, scale), 1e-5, t)

    # a band of `band` diagonals, sized to about the same nnz
    nb = max((n * per_row // band) // 128 * 128, 256)
    sb = banded_csr(nb, band, seed)
    S = prepare_spmv(CSR.from_scipy(sb))
    if not isinstance(S, StripDense):
        raise AssertionError(f"banded matrix not strip-routed: {type(S)}")
    Xb = g.random((nb, k), dtype=np.float32) * 2 - 1
    Yb, tb = _timed(ctx, f, S, jnp.asarray(Xb))
    want = sb.astype(np.float64) @ Xb.astype(np.float64)
    scale = abs(sb).astype(np.float64) @ np.abs(Xb).astype(np.float64)
    report(ctx, "spmm-strip", f"band {band} {nb}x{nb} @ {nb}x{k} "
           f"(strips {S.strips.shape})", sb.nnz,
           spmm_bytes(S.strips.size, nb, nb, k, idx_bytes=0),
           "fp32 HIGHEST (true fp32)", scaled_err(Yb, want, scale), 1e-5, tb)


def _codebook(m: int, n: int, k: int, density: float, seed: int):
    """a (m×k), c (m×n) and the stored B^T index plane (n×k, uint8, 255 =
    zero) with its 255-entry table — the reference's generator
    (values in ±1000)."""
    g = np.random.default_rng(seed)
    a = g.uniform(-1000, 1000, (m, k)).astype(np.float32)
    c = g.uniform(-1000, 1000, (m, n)).astype(np.float32)
    table = g.uniform(-1000, 1000, 255).astype(np.float32)
    idx = g.integers(0, 255, size=(n, k), dtype=np.uint8)
    idx[g.random((n, k), dtype=np.float32) >= density] = 255
    return a, c, idx, table


def phase_codebook(ctx: Ctx, parity=(117, 1023, 2047),
                   card=(256, 16384, 16384), density: float = 0.25,
                   n_cols: int = 512, seed: int = 3):
    """The reference's operation ``C = C + A @ B`` with B codebook-sparse
    (``add_mat_mat`` on a ``CodebookDense``): the reference's parity shape
    checked whole with its own policy, and a card-scale shape checked on
    sampled output columns in float64."""
    import jax
    import jax.numpy as jnp

    from sparsematrix_tpu import add_mat_mat
    from sparsematrix_tpu.formats import CodebookDense
    from sparsematrix_tpu.utils.testutils import relative_check

    f = jax.jit(lambda a, b, c: add_mat_mat(a, b, c, 1.0, 1.0))
    prec = "fp32 HIGHEST (true fp32)"
    for tag, (m, n, k) in (("parity", parity), ("card", card)):
        a, c, idx, table = _codebook(m, n, k, density, seed)
        b_t = CodebookDense.from_index_matrix(idx, table)
        out, t = _timed(ctx, f, jnp.asarray(a), b_t, jnp.asarray(c))
        table64 = np.concatenate([table, [0.0]]).astype(np.float64)
        # bytes: the index plane, A and C in, C out
        nbytes = n * k + 4 * (m * k + 2 * m * n)
        if tag == "parity":
            # the reference's policy: relative error ≤ 0.1 on all but
            # size·1e-4 entries (relative_check); err counts the outliers
            want = c + a.astype(np.float64) @ table64[idx].T
            got = np.asarray(out, np.float64)
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
            outliers = int(np.sum((rel > 0.1) & ~((np.abs(want) < 1e-3)
                                                 & (np.abs(got) < 1e-3))))
            if not relative_check(got, want):
                raise AssertionError("add_mat_mat parity: relative_check")
            report(ctx, "add_mat_mat", f"{tag} {m}x{n}x{k} d={density} "
                   f"(relative_check: outliers over rel 0.1; max rel "
                   f"{rel.max():.2e})", b_t.nnz, nbytes, prec,
                   float(outliers), float(max(1, int(got.size * 1e-4))), t)
            continue
        cols = np.random.default_rng(seed).choice(n, n_cols, replace=False)
        bcols = table64[idx[cols]]  # (n_cols, k)
        want = c[:, cols] + a.astype(np.float64) @ bcols.T
        scale = np.abs(c[:, cols]) + np.abs(a).astype(np.float64) @ np.abs(
            bcols).T
        err = scaled_err(np.asarray(out)[:, cols], want, scale)
        report(ctx, "add_mat_mat", f"{tag} {m}x{n}x{k} d={density} "
               f"({n_cols} sampled columns)", b_t.nnz, nbytes, prec, err,
               1e-4, t)


def _exact_pattern(C, ref):
    ref = ref.tocsr()
    ref.sort_indices()
    if not (np.array_equal(np.asarray(C.indptr), ref.indptr)
            and np.array_equal(np.asarray(C.indices)[: C.nnz], ref.indices)):
        raise AssertionError("SpGEMM pattern differs from scipy's")
    return ref


def phase_spgemm(ctx: Ctx, side: int = 1024):
    """``spgemm(A, A)`` on the 2-D Poisson matrix, CSR and CSC outputs:
    the pattern must equal scipy's exactly, values to rtol 1e-5."""
    import jax

    from sparsematrix_tpu import CSR
    from sparsematrix_tpu.ops import spgemm, spgemm_apply, spgemm_plan

    sp = poisson2d(side)
    A = CSR.from_scipy(sp)
    want = sp.astype(np.float64) @ sp.astype(np.float64)
    apply_ = jax.jit(lambda p, a, b: spgemm_apply(p, a, b).data)
    for output, ref, ops in (("csr", want, (A, A)),
                             ("csc", want.T, (A.transpose(), A.transpose()))):
        C = spgemm(A, A, output=output)
        ref = _exact_pattern(C, ref)
        err = scaled_err(np.asarray(C.data)[: C.nnz], ref.data,
                         np.abs(ref.data))
        t0 = time.perf_counter()
        plan = spgemm_plan(*ops)
        plan_s = time.perf_counter() - t0
        _, t = _timed(ctx, apply_, plan, ops[0].data, ops[1].data)
        nbytes = plan.n_pairs * (2 * 4 + 3 * 4) + plan.c_nnz * 4
        report(ctx, "spgemm", f"poisson {side}^2 A@A output={output} "
               f"pairs={plan.n_pairs} c_nnz={plan.c_nnz} "
               f"(plan {plan_s:.2f} s host)", sp.nnz, nbytes,
               "fp32 (gather + segment-sum)", err, 1e-5, t)


def phase_solve(ctx: Ctx, side: int = 512, tol: float = 1e-6,
                maxiter: int = 20000):
    """CG (plain, ILU(0), IC(0)) on the 2-D Poisson matrix to ``tol``,
    the true residual certified in float64 on the host; and ``trisolve``
    on the ILU L factor against scipy."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    from sparsematrix_tpu import CSR
    from sparsematrix_tpu.ops import (ic0_plans, ic_apply, ilu0, ilu0_plans,
                                      ilu_apply, trisolve, trisolve_apply,
                                      trisolve_plan)
    from sparsematrix_tpu.solvers import cg
    from sparsematrix_tpu.utils.roofline import spmv_csr_bytes

    sp = poisson2d(side)
    n = sp.shape[0]
    A = CSR.from_scipy(sp)
    b = np.random.default_rng(5).random(n, dtype=np.float32) * 2 - 1
    bj = jnp.asarray(b)
    sp64 = sp.astype(np.float64)
    for name, builder, apply_ in (("plain", None, None),
                                  ("ilu0", ilu0_plans, ilu_apply),
                                  ("ic0", ic0_plans, ic_apply)):
        t0 = time.perf_counter()
        plans = builder(A) if builder is not None else None
        setup_s = time.perf_counter() - t0

        def solve(A_, b_, plans_, apply_=apply_):
            M = (None if plans_ is None
                 else (lambda r: apply_(plans_, r)))
            return cg(A_, b_, tol=tol, maxiter=maxiter, M=M)

        res, t = _timed(ctx, jax.jit(solve), A, bj, plans, reps=1)
        iters = int(res.iters)
        if iters >= maxiter:
            raise AssertionError(f"cg-{name}: no convergence in {maxiter}")
        x = np.asarray(res.x, np.float64)
        true_rel = float(np.linalg.norm(b - sp64 @ x) / np.linalg.norm(b))
        report(ctx, f"cg-{name}", f"poisson {side}^2 rtol {tol:g}, "
               f"{iters} iterations, set-up {setup_s:.3f} s host",
               sp.nnz, iters * spmv_csr_bytes(sp.nnz, n, n),
               "fp32 (true residual certified in float64)", true_rel, 1e-5,
               t, reps=1)

    L, _ = ilu0(A)
    x = trisolve(L, bj, lower=True, unit_diagonal=True)
    want = spla.spsolve_triangular(L.to_scipy().astype(np.float64),
                                   b.astype(np.float64), lower=True,
                                   unit_diagonal=True)
    err = float(np.linalg.norm(np.asarray(x, np.float64) - want)
                / np.linalg.norm(want))
    plan = trisolve_plan(L, lower=True, unit_diagonal=True)
    _, t = _timed(ctx, jax.jit(trisolve_apply), plan, bj)
    report(ctx, "trisolve", f"ILU(0) L of poisson {side}^2, "
           f"{plan.rows.shape[0]} levels (normwise rel err)", L.nnz,
           spmv_csr_bytes(L.nnz, n, n), "fp32 (level scan)", err, 1e-5, t)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _check_sharded(arr, n_dev: int, what: str):
    """Each of ``n_dev`` devices holds its own shard of ``arr``."""
    shards = arr.addressable_shards
    devices = {s.device for s in shards}
    if len(devices) != n_dev or any(
            s.data.shape[0] * n_dev != arr.shape[0] for s in shards):
        raise AssertionError(
            f"{what}: shards on {len(devices)} devices, shapes "
            f"{[s.data.shape for s in shards]} of {arr.shape}")


def phase_four(ctx: Ctx, n: int = 1 << 20, per_row: int = 32, k: int = 32,
               band: int = 32, side: int = 512, ragged=(False, True),
               seed: int = 1):
    """The distributed path on four devices, each result compared with
    the same op on one device and with the host reference."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sparsematrix_tpu import CSR, spmm, spmv
    from sparsematrix_tpu.ops import spgemm
    from sparsematrix_tpu.parallel import (
        block_ilu0_precond, dist_cg, dist_spgemm_apply, dist_spgemm_plan,
        dist_spmm, dist_spmm_2d, dist_spmv, dist_spmv_halo_var,
        make_mesh, make_mesh_2d, partition_csr_cols, partition_csr_halo_var,
        partition_csr_rows, shard_dist_spgemm, shard_partitioned)
    from sparsematrix_tpu.solvers import cg
    from sparsematrix_tpu.utils.roofline import spmm_bytes, spmv_csr_bytes

    nd = 4
    if len(jax.devices()) < nd:
        raise SystemExit(f"--four needs {nd} devices, JAX sees "
                         f"{len(jax.devices())}")
    mesh = make_mesh(nd)
    one = jax.devices()[0]
    g = np.random.default_rng(seed + 100)

    def check(op, shape, nnz, nbytes, got, single, host, scale, fn, *args):
        got = np.asarray(got, np.float64)
        err = max(scaled_err(got, single, scale), scaled_err(got, host, scale))
        _, t = _timed(ctx, fn, *args)
        report(ctx, op, shape + " (vs 1 device and host)", nnz, nbytes,
               "fp32", err, 1e-5, t)

    # phase 1's matrix, row and column partitions
    sp = uniform_csr(n, per_row, seed)
    A = CSR.from_scipy(sp)
    x = g.random(n, dtype=np.float32) * 2 - 1
    X = g.random((n, k), dtype=np.float32) * 2 - 1
    xj, Xj = jnp.asarray(x), jnp.asarray(X)
    sp64, abs64 = sp.astype(np.float64), abs(sp).astype(np.float64)
    y_host = sp64 @ x.astype(np.float64)
    y_scale = abs64 @ np.abs(x).astype(np.float64)
    Y_host = sp64 @ X.astype(np.float64)
    Y_scale = abs64 @ np.abs(X).astype(np.float64)
    A1 = jax.device_put(A, one)
    y_one = np.asarray(jax.jit(spmv)(A1, jax.device_put(xj, one)), np.float64)
    Y_one = np.asarray(jax.jit(spmm)(A1, jax.device_put(Xj, one)),
                       np.float64)
    vb = spmv_csr_bytes(sp.nnz, n, n)
    mb = spmm_bytes(sp.nnz, n, n, k)

    rows = shard_partitioned(partition_csr_rows(A, nd), mesh)
    cols = shard_partitioned(partition_csr_cols(A, nd), mesh)
    for part, tag in ((rows, "rows"), (cols, "cols")):
        for leaf in (part.indices, part.data, part.row_ids):
            _check_sharded(leaf, nd, f"{tag} partition")
    f = jax.jit(lambda p, v: dist_spmv(p, v, mesh))
    y = f(rows, xj)
    _check_sharded(y, nd, "dist_spmv rows output")
    check("dist_spmv", f"rows x{nd} {n}x{n}", sp.nnz, vb, y, y_one, y_host,
          y_scale, f, rows, xj)
    for reduce in ("psum", "psum_scatter"):
        f = jax.jit(lambda p, v, r=reduce: dist_spmv(p, v, mesh, reduce=r))
        check("dist_spmv", f"cols x{nd} {reduce} {n}x{n}", sp.nnz, vb,
              f(cols, xj), y_one, y_host, y_scale, f, cols, xj)
    f = jax.jit(lambda p, M: dist_spmm(p, M, mesh))
    check("dist_spmm", f"rows x{nd} {n}x{n} @ {n}x{k}", sp.nnz, mb,
          f(rows, Xj), Y_one, Y_host, Y_scale, f, rows, Xj)
    mesh2 = make_mesh_2d(2, 2)
    rows2 = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh2, P("row"))),
        partition_csr_rows(A, 2))
    f = jax.jit(lambda p, M: dist_spmm_2d(p, M, mesh2))
    Y2 = f(rows2, Xj)
    if len({s.device for s in Y2.addressable_shards}) != nd:
        raise AssertionError("dist_spmm_2d output not on 4 devices")
    check("dist_spmm_2d", f"2x2 mesh {n}x{n} @ {n}x{k}", sp.nnz, mb, Y2,
          Y_one, Y_host, Y_scale, f, rows2, Xj)

    # distributed CG on the 2-D Poisson matrix: Jacobi and block-ILU(0)
    pp = poisson2d(side)
    npo = pp.shape[0]
    P_ = CSR.from_scipy(pp)
    bvec = np.random.default_rng(5).random(npo, dtype=np.float32) * 2 - 1
    bj = jnp.asarray(bvec)
    prow = shard_partitioned(partition_csr_rows(P_, nd), mesh)
    dinv = jnp.asarray(1.0 / pp.diagonal())
    Mb = block_ilu0_precond(P_, nd)
    lr = -(-npo // nd)

    def block_apply(r):  # the same block-diagonal ILU(0), on one device
        rb = jnp.zeros((nd * lr,), r.dtype).at[:npo].set(r).reshape(nd, lr)
        z = jax.vmap(lambda rr, st: Mb.fn(
            rr, jax.tree_util.tree_map(lambda a: a[None], st)))(rb, Mb.state)
        return z.reshape(-1)[:npo]

    pp64 = pp.astype(np.float64)
    for name, pre, M1 in (("jacobi", "jacobi", lambda r: r * dinv),
                          ("block-ilu0", Mb, block_apply)):
        f = jax.jit(lambda p, v, pre=pre: dist_cg(p, v, mesh, precond=pre,
                                                   tol=1e-6, maxiter=20000))
        res, t = _timed(ctx, f, prow, bj, reps=1)
        res1 = jax.jit(lambda A_, v, M1=M1: cg(A_, v, tol=1e-6,
                                               maxiter=20000, M=M1))(P_, bj)
        x4 = np.asarray(res.x, np.float64)
        x1 = np.asarray(res1.x, np.float64)
        it4, it1 = int(res.iters), int(res1.iters)
        rel4 = float(np.linalg.norm(bvec - pp64 @ x4) / np.linalg.norm(bvec))
        rel1 = float(np.linalg.norm(bvec - pp64 @ x1) / np.linalg.norm(bvec))
        if abs(it4 - it1) > max(3, it1 // 20) or rel1 > 1e-5:
            raise AssertionError(f"dist_cg {name}: {it4} iterations vs "
                                 f"{it1} on one device (residual {rel1:.2e})")
        diff = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
        report(ctx, "dist_cg", f"{name} x{nd} poisson {side}^2 rtol 1e-6, "
               f"{it4} iterations (1 device: {it1}, true residual "
               f"{rel1:.2e}; |x4-x1|/|x1|={diff:.2e})", pp.nnz,
               it4 * spmv_csr_bytes(pp.nnz, npo, npo),
               "fp32 (true residual in float64)", rel4, 1e-5, t, reps=1)

    # k-split SpGEMM: partial products psum'd over the mesh
    plan = shard_dist_spgemm(dist_spgemm_plan(P_, P_, nd), mesh)
    _check_sharded(plan.pa, nd, "dist_spgemm plan")
    f = jax.jit(lambda p: dist_spgemm_apply(p, mesh).data)
    C4 = f(plan)
    C1 = spgemm(P_, P_, method="sparse")
    ref = _exact_pattern(C1, pp64 @ pp64)
    got = np.asarray(C4)[: plan.c_nnz]
    err = max(scaled_err(got, ref.data, np.abs(ref.data)),
              scaled_err(got, np.asarray(C1.data)[: C1.nnz],
                         np.abs(ref.data)))
    if not np.array_equal(np.asarray(plan.c_indices)[: plan.c_nnz],
                          ref.indices):
        raise AssertionError("dist_spgemm pattern differs from scipy's")
    _, t = _timed(ctx, f, plan)
    report(ctx, "dist_spgemm", f"k-split x{nd} poisson {side}^2 A@A "
           f"(vs 1 device and host)", pp.nnz,
           int(np.prod(plan.pa.shape)) * 20 + plan.c_nnz * 4, "fp32", err,
           1e-5, t)

    # variable-width halos on a banded matrix of the same size, both
    # exchange branches
    sb = banded_csr(n, band, seed)
    hpart = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("shard"))),
        partition_csr_halo_var(CSR.from_scipy(sb), nd))
    _check_sharded(hpart.data, nd, "halo partition")
    yb_host = sb.astype(np.float64) @ x.astype(np.float64)
    yb_scale = abs(sb).astype(np.float64) @ np.abs(x).astype(np.float64)
    yb_one = np.asarray(jax.jit(spmv)(jax.device_put(CSR.from_scipy(sb), one),
                                      jax.device_put(xj, one)), np.float64)
    for use_ragged in ragged:
        f = jax.jit(lambda p, v, r=use_ragged: dist_spmv_halo_var(
            p, v, mesh, use_ragged=r))
        branch = "ragged_all_to_all" if use_ragged else "padded ppermute"
        check("dist_spmv_halo_var", f"band {band} x{nd} {n}x{n} {branch} "
              f"(halo bytes ragged={hpart.ragged_bytes} "
              f"padded={hpart.padded_bytes})", sb.nnz,
              spmv_csr_bytes(sb.nnz, n, n), f(hpart, xj), yb_one, yb_host,
              yb_scale, f, hpart, xj)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed phase")
    args = ap.parse_args(argv)

    card = card_info()
    print(card, flush=True)
    import jax

    devices = jax.devices()
    print(devices, flush=True)
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); there is no CPU fallback",
              file=sys.stderr)
        raise SystemExit(2)

    from sparsematrix_tpu.utils.compile_cache import enable_compile_cache
    from sparsematrix_tpu.utils.roofline import chip_spec

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    ctx = Ctx(card=card, bw=chip_spec(devices[0].device_kind).hbm_gbps * 1e9)
    if args.four:
        phase_four(ctx)
    else:
        for phase in (phase_spmv, phase_spmm, phase_codebook, phase_spgemm,
                      phase_solve):
            t0 = time.perf_counter()
            phase(ctx)
            print(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s "
                  f"wall, set-up and compiles included)", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
