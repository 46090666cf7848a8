"""The XLA paths held to the matrix classes the removed layout kernels were
tested on: every (class, op, dtype) against a float64 numpy reference.

Tolerances are the standard summation bound: a sum of ``d`` products in a
format with unit roundoff ``u`` errs by at most ``(d + 2)·u·Σ|a||x|``, so
each output is held to ``(d_max + 2)·u`` times its own ``|A||x|`` scale
(u = 2⁻²⁴ for fp32, 2⁻⁸ for bf16).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import spmm, spmv, spmv_t


def _uniform(rng, m, n, per_row):
    d = np.zeros((m, n), np.float32)
    for i in range(m):
        d[i, rng.choice(n, per_row, replace=False)] = rng.uniform(-1, 1,
                                                                  per_row)
    return d


def _banded(rng, n=96, half=3):
    d = np.zeros((n, n), np.float32)
    for o in range(-half, half + 1):
        i = np.arange(max(0, -o), min(n, n - o))
        d[i, i + o] = rng.uniform(-1, 1, i.size)
    return d


def _block_tridiagonal(rng, nb=12, bs=8):
    mask = np.eye(nb, k=-1) + np.eye(nb) + np.eye(nb, k=1)
    return (np.kron(mask, np.ones((bs, bs)))
            * rng.uniform(-1, 1, (nb * bs, nb * bs))).astype(np.float32)


def _scattered(rng, n=96):
    d = np.zeros((n, n), np.float32)
    for i in range(n):
        k = rng.integers(0, 3)  # 0, 1 or 2 entries
        d[i, rng.choice(n, k, replace=False)] = rng.uniform(-1, 1, k)
    return d


def _zipf_rows(rng, n=96):
    deg = np.clip((n / (np.arange(n) + 1.0) ** 0.9).astype(int), 1, n)
    rng.shuffle(deg)
    d = np.zeros((n, n), np.float32)
    for i in range(n):
        d[i, rng.choice(n, deg[i], replace=False)] = rng.uniform(-1, 1,
                                                                 deg[i])
    return d


def _hub_column(rng, n=96):
    d = _uniform(rng, n, n, 2)
    d[:, 17] = rng.uniform(-1, 1, n)
    return d


def _empty_rows(rng, n=96):
    d = _uniform(rng, n, n, 8)
    d[rng.choice(n, n // 2, replace=False)] = 0
    return d


def _dense_row(rng, n=96):
    d = _uniform(rng, n, n, 2)
    d[5] = rng.uniform(-1, 1, n)
    return d


CLASSES = {
    "uniform-1": lambda r: _uniform(r, 96, 160, 1),
    "uniform-4": lambda r: _uniform(r, 96, 160, 4),
    "uniform-16": lambda r: _uniform(r, 96, 160, 16),
    "uniform-64": lambda r: _uniform(r, 96, 160, 64),
    "uniform-128": lambda r: _uniform(r, 96, 160, 128),
    "banded": _banded,
    "block-tridiagonal": _block_tridiagonal,
    "scattered-le2": _scattered,
    "zipf-rows": _zipf_rows,
    "hub-column": _hub_column,
    "empty-rows": _empty_rows,
    "one-dense-row": _dense_row,
    "tall": lambda r: _uniform(r, 200, 40, 6),
    "wide": lambda r: _uniform(r, 40, 200, 20),
    "all-zero": lambda r: np.zeros((96, 96), np.float32),
}
OPS = ["spmv", "spmm-k1", "spmm-k8", "spmm-k64", "spmv_t", "grad-x",
       "grad-values"]
UNIT_ROUNDOFF = {"fp32": 2.0 ** -24, "bf16": 2.0 ** -8}
DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _round(a, dtype):
    """Values as the device stores them, in float64."""
    return np.asarray(jnp.asarray(a).astype(dtype).astype(jnp.float32),
                      np.float64)


def _check(got, want, scale, d_max, u):
    got = np.asarray(jnp.asarray(got).astype(jnp.float32), np.float64)
    assert got.shape == want.shape
    bound = (d_max + 2) * u * scale + 1e-30
    worst = np.max(np.abs(got - want) - bound, initial=-1.0)
    assert worst <= 0, (np.abs(got - want).max(), bound.max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("cls", list(CLASSES))
def test_matrix_class(cls, op, dtype):
    rng = np.random.default_rng(zlib.crc32(f"{cls}/{op}".encode()))
    dense = CLASSES[cls](rng)
    m, n = dense.shape
    dt = DTYPES[dtype]
    u = UNIT_ROUNDOFF[dtype]
    A = CSR.fromdense(dense, capacity=int((dense != 0).sum()) + 5)
    A = dataclasses.replace(A, data=A.data.astype(dt))
    a64 = _round(dense, dt)
    d_max = int(max((dense != 0).sum(axis=1).max(initial=0),
                    (dense != 0).sum(axis=0).max(initial=0)))
    x = rng.uniform(-1, 1, n).astype(np.float32)
    w = rng.uniform(-1, 1, m).astype(np.float32)
    x64, w64 = _round(x, dt), _round(w, dt)
    xj, wj = jnp.asarray(x).astype(dt), jnp.asarray(w).astype(dt)

    if op == "spmv":
        _check(spmv(A, xj), a64 @ x64, np.abs(a64) @ np.abs(x64), d_max, u)
    elif op.startswith("spmm"):
        k = int(op.split("-k")[1])
        X = rng.uniform(-1, 1, (n, k)).astype(np.float32)
        X64 = _round(X, dt)
        # the dense route sums over every column, so hold it to n terms
        _check(spmm(A, jnp.asarray(X).astype(dt)), a64 @ X64,
               np.abs(a64) @ np.abs(X64), n, u)
    elif op == "spmv_t":
        _check(spmv_t(A, wj), a64.T @ w64, np.abs(a64).T @ np.abs(w64),
               d_max, u)
    elif op == "grad-x":
        g = jax.grad(lambda v: jnp.vdot(wj, spmv(A, v)).astype(jnp.float32))(
            xj)
        _check(g, a64.T @ w64, np.abs(a64).T @ np.abs(w64), d_max, u)
    else:  # grad-values: d<w, A x>/d a_k = w[row_k] x[col_k]
        def loss(data):
            return jnp.vdot(wj, spmv(dataclasses.replace(A, data=data),
                                     xj)).astype(jnp.float32)

        g = jax.grad(loss)(A.data)
        rid = np.asarray(A.row_ids)
        cid = np.asarray(A.indices)
        live = rid < m
        want = np.where(live, w64[np.minimum(rid, m - 1)] * x64[cid], 0.0)
        _check(g, want, np.abs(want), 0, u)
