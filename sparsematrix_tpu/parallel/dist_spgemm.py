"""Distributed SpGEMM: ``C = A @ B`` with the contraction (k) dimension
split across devices.

Host symbolic phase: A is column-partitioned and B row-partitioned into k
bands; each shard's contraction pairs are planned against the **global** C
structure (the union pattern), so every device produces a partial ``c_data``
vector of identical static shape.  Device numeric phase: local
gather-multiply-segment_sum + ``psum`` over the mesh — the
analogue of a 2-D block SpGEMM with partial-product reduction
(SURVEY §2.4 north-star capability; no reference analogue).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import CSR
from ..formats.base import default_index_dtype, register_sparse_pytree

__all__ = ["DistSpGEMMPlan", "dist_spgemm_plan", "shard_dist_spgemm",
           "dist_spgemm_apply"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class DistSpGEMMPlan:
    """Per-shard pair programs stacked on a leading device axis, all
    targeting the same global C structure."""

    pa: jnp.ndarray  # (n_shards, pair_cap) into local A-band data
    pb: jnp.ndarray  # (n_shards, pair_cap) into local B-band data
    target: jnp.ndarray  # (n_shards, pair_cap) into global C data
    a_data: jnp.ndarray  # (n_shards, a_cap) band values of A
    b_data: jnp.ndarray  # (n_shards, b_cap) band values of B
    c_indptr: jnp.ndarray  # (m+1,)
    c_indices: jnp.ndarray  # (c_cap,)
    c_row_ids: jnp.ndarray  # (c_cap,)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_shards: int = dataclasses.field(metadata={"static": True})
    c_nnz: int = dataclasses.field(metadata={"static": True})


def dist_spgemm_plan(A: CSR, B: CSR, n_shards: int) -> DistSpGEMMPlan:
    sa = A.to_scipy().tocsr()
    sb = B.to_scipy().tocsr()
    m, k = sa.shape
    k2, n = sb.shape
    if k != k2:
        raise ValueError("inner dims mismatch")

    # global C structure
    pattern = ((sa != 0) @ (sb != 0)).tocsr()
    pattern.sort_indices()
    c_nnz = int(pattern.nnz)
    c_indptr, c_indices = pattern.indptr, pattern.indices
    c_rows = np.repeat(np.arange(m), np.diff(c_indptr))
    key_c = c_rows.astype(np.int64) * n + c_indices.astype(np.int64)

    band = -(-k // n_shards)
    per = []
    for s in range(n_shards):
        k0, k1 = s * band, min((s + 1) * band, k)
        a_band = sa[:, k0:k1].tocsr()  # m × band
        b_band = sb[k0:k1, :].tocsr()  # band × n
        a_band.sort_indices()
        b_band.sort_indices()
        # vectorized pair enumeration against global C slots (same scheme
        # as ops.spgemm_plan: searchsorted into the sorted C key space)
        b_indptr = b_band.indptr.astype(np.int64)
        a_rows = np.repeat(np.arange(m), np.diff(a_band.indptr))
        ka = a_band.indices.astype(np.int64)
        cnt = b_indptr[ka + 1] - b_indptr[ka]
        npair = int(cnt.sum())
        pa_v = np.repeat(np.arange(len(ka)), cnt)
        starts = np.cumsum(cnt) - cnt
        off = np.arange(npair) - np.repeat(starts, cnt)
        pb_v = b_indptr[ka[pa_v]] + off
        key_p = (a_rows[pa_v].astype(np.int64) * n
                 + b_band.indices[pb_v].astype(np.int64))
        tgt_v = np.searchsorted(key_c, key_p)
        per.append((a_band, b_band, pa_v, pb_v, tgt_v))

    pair_cap = max(max(len(p[2]) for p in per), 1)
    a_cap = max(max(int(p[0].nnz) for p in per), 1)
    b_cap = max(max(int(p[1].nnz) for p in per), 1)
    c_cap = max(c_nnz, 1)

    pa = np.zeros((n_shards, pair_cap), np.int64)
    pb = np.zeros((n_shards, pair_cap), np.int64)
    tgt = np.full((n_shards, pair_cap), c_cap, np.int64)
    a_data = np.zeros((n_shards, a_cap), sa.data.dtype)
    b_data = np.zeros((n_shards, b_cap), sb.data.dtype)
    for s, (ab, bb, pa_l, pb_l, tgt_l) in enumerate(per):
        npair = len(pa_l)
        pa[s, :npair] = pa_l
        pb[s, :npair] = pb_l
        tgt[s, :npair] = tgt_l
        a_data[s, : ab.nnz] = ab.data
        b_data[s, : bb.nnz] = bb.data

    ci = np.zeros(c_cap, np.int64)
    ci[:c_nnz] = c_indices
    crow = np.full(c_cap, m, np.int64)
    crow[:c_nnz] = np.repeat(np.arange(m), np.diff(c_indptr))
    idt = default_index_dtype
    return DistSpGEMMPlan(
        pa=jnp.asarray(pa, idt),
        pb=jnp.asarray(pb, idt),
        target=jnp.asarray(tgt, idt),
        a_data=jnp.asarray(a_data),
        b_data=jnp.asarray(b_data),
        c_indptr=jnp.asarray(c_indptr, idt),
        c_indices=jnp.asarray(ci, idt),
        c_row_ids=jnp.asarray(crow, idt),
        shape=(m, n),
        n_shards=n_shards,
        c_nnz=c_nnz,
    )


def shard_dist_spgemm(plan: DistSpGEMMPlan, mesh: Mesh, axis_name: str = "shard"):
    """Place per-shard arrays sharded, C structure replicated."""
    sharded = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())
    put_s = lambda a: jax.device_put(a, sharded)
    put_r = lambda a: jax.device_put(a, repl)
    return dataclasses.replace(
        plan,
        pa=put_s(plan.pa),
        pb=put_s(plan.pb),
        target=put_s(plan.target),
        a_data=put_s(plan.a_data),
        b_data=put_s(plan.b_data),
        c_indptr=put_r(plan.c_indptr),
        c_indices=put_r(plan.c_indices),
        c_row_ids=put_r(plan.c_row_ids),
    )


def dist_spgemm_apply(plan: DistSpGEMMPlan, mesh: Mesh,
                      axis_name: str = "shard") -> CSR:
    """Numeric phase: per-device partials + psum (jittable)."""
    c_cap = plan.c_indices.shape[0]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name)),
        out_specs=P(None),
    )
    def run(pa, pb, tgt, a_data, b_data):
        prod = a_data[0][pa[0]] * b_data[0][pb[0]]
        partial = jax.ops.segment_sum(prod, tgt[0], num_segments=c_cap + 1)[:-1]
        return jax.lax.psum(partial, axis_name)

    c_data = run(plan.pa, plan.pb, plan.target, plan.a_data, plan.b_data)
    return CSR(
        indptr=plan.c_indptr,
        indices=plan.c_indices,
        data=c_data,
        row_ids=plan.c_row_ids,
        shape=plan.shape,
        nnz=plan.c_nnz,
    )
