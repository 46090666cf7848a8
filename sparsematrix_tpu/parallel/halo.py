"""Halo-exchange distributed SpMV for banded/local structure.

When each shard's rows only touch columns within ``halo`` of its own x
band (banded matrices, local stencils), the full ``all_gather`` of the RHS
is wasteful: each device only needs its own band plus a halo from its two
ring neighbors.  This implements that exchange with ``jax.lax.ppermute``
(neighbor traffic, O(halo) instead of O(n) per device) — the "halo
segments of the x-vector exchanged between devices" capability of the
north star.

The partitioner verifies the locality assumption at build time and rebases
column indices into the (halo | own band | halo) local frame.
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

from ..formats.base import default_index_dtype, register_sparse_pytree
from ..formats.csr import CSR

__all__ = ["HaloPartitionedCSR", "partition_csr_halo", "dist_spmv_halo",
           "RingHaloCSR", "partition_csr_halo_ring", "dist_spmv_halo_ring"]


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class HaloPartitionedCSR:
    indices: jnp.ndarray  # (n_shards, cap) local col ids in halo frame
    data: jnp.ndarray  # (n_shards, cap)
    row_ids: jnp.ndarray  # (n_shards, cap) local rows (pad → local_rows)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_shards: int = dataclasses.field(metadata={"static": True})
    local_rows: int = dataclasses.field(metadata={"static": True})
    band: int = dataclasses.field(metadata={"static": True})  # x per shard
    halo: int = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})


def partition_csr_halo(csr: CSR, n_shards: int, halo: int) -> HaloPartitionedCSR:
    """Row-partition with halo-local column rebasing.

    Raises if any entry reaches beyond ``halo`` columns outside its shard's
    own x band (use the all-gather path for such matrices).
    """
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_rows = -(-rows // n_shards)
    band = -(-cols // n_shards)
    if halo > band:
        raise ValueError(f"halo {halo} larger than band {band}")
    caps = []
    shards = []
    for s in range(n_shards):
        r0, r1 = s * local_rows, min((s + 1) * local_rows, rows)
        sub = sp[r0:r1]
        c0 = s * band
        lo, hi = c0 - halo, c0 + band + halo
        if sub.nnz:
            cmin, cmax = int(sub.indices.min()), int(sub.indices.max())
            if cmin < lo or cmax >= hi:
                raise ValueError(
                    f"shard {s}: columns [{cmin}, {cmax}] exceed halo window "
                    f"[{lo}, {hi}) — matrix is not {halo}-local"
                )
        caps.append(int(sub.nnz))
        shards.append((r0, sub, lo))
    cap = max(max(caps), 1)
    n_idx = np.zeros((n_shards, cap), np.int64)
    n_dat = np.zeros((n_shards, cap), sp.data.dtype)
    n_rid = np.full((n_shards, cap), local_rows, np.int64)
    for s, (r0, sub, lo) in enumerate(shards):
        k = int(sub.nnz)
        n_idx[s, :k] = sub.indices - lo  # halo-frame local columns
        n_dat[s, :k] = sub.data
        n_rid[s, :k] = np.repeat(np.arange(sub.shape[0]), np.diff(sub.indptr))
    idt = default_index_dtype
    return HaloPartitionedCSR(
        indices=jnp.asarray(n_idx, idt),
        data=jnp.asarray(n_dat),
        row_ids=jnp.asarray(n_rid, idt),
        shape=(rows, cols),
        n_shards=n_shards,
        local_rows=local_rows,
        band=band,
        halo=halo,
        nnz=csr.nnz,
    )


def shard_halo(part: HaloPartitionedCSR, mesh: Mesh, axis_name: str = "shard"):
    spec = NamedSharding(mesh, P(axis_name))
    return dataclasses.replace(
        part,
        indices=jax.device_put(part.indices, spec),
        data=jax.device_put(part.data, spec),
        row_ids=jax.device_put(part.row_ids, spec),
    )


def dist_spmv_halo(part: HaloPartitionedCSR, x, mesh: Mesh,
                   axis_name: str = "shard"):
    """``y = A @ x`` exchanging only O(halo) per neighbor via ppermute."""
    n = part.n_shards
    h = part.halo
    band = part.band
    x_pad = jnp.zeros((n * band,), x.dtype).at[: x.shape[0]].set(x)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )
    def run(indices, data, row_ids, x_local):
        # send band edges to ring neighbors (wrap links carry zeros
        # logically, since edge shards have no out-of-range entries)
        right_halo_src = x_local[-h:]  # to right neighbor's left halo
        left_halo_src = x_local[:h]  # to left neighbor's right halo
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        from_left = jax.lax.ppermute(right_halo_src, axis_name, fwd)
        from_right = jax.lax.ppermute(left_halo_src, axis_name, bwd)
        x_frame = jnp.concatenate([from_left, x_local, from_right])
        prod = data[0] * x_frame[indices[0]]
        return jax.ops.segment_sum(prod, row_ids[0],
                                   num_segments=part.local_rows)

    y = run(part.indices, part.data, part.row_ids, x_pad)
    return y.reshape(-1)[: part.shape[0]]


# ---------------------------------------------------------------------------
# Ring-pipelined halo SpMV: compute/communication overlap.
#
# ``dist_spmv_halo`` above is exchange-THEN-compute: the whole local matvec
# waits on the ppermutes.  For overlap (SURVEY §2.4/§5: halo exchange
# "overlapped with local-block compute"), the matrix is split at PACK time
# into the owned-column block (columns inside the shard's own x band) and
# the halo-column block (columns in the neighbor halos).  The kernel then
#
#   1. issues both ppermutes,
#   2. computes the owned partial product — which has NO data dependency
#      on the collectives, so XLA's scheduler runs the transfer and
#      the owned gather/segment-sum concurrently,
#   3. finishes with the (small) halo partial once the halos land.
#
# The owned block is ~(band-2h)/band of the nnz, so nearly all the local
# compute hides the exchange.  tests/test_halo_ring.py checks 2/4/8-device
# numerics AND the structural property (the owned partial is not a
# descendant of the ppermute outputs in the jaxpr — overlappable).
# ---------------------------------------------------------------------------


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class RingHaloCSR:
    own_indices: jnp.ndarray  # (n_shards, cap_o) band-local col ids
    own_data: jnp.ndarray  # (n_shards, cap_o)
    own_rows: jnp.ndarray  # (n_shards, cap_o) local rows (pad → local_rows)
    halo_indices: jnp.ndarray  # (n_shards, cap_h) ids in the (2h,) frame
    halo_data: jnp.ndarray  # (n_shards, cap_h)
    halo_rows: jnp.ndarray  # (n_shards, cap_h)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_shards: int = dataclasses.field(metadata={"static": True})
    local_rows: int = dataclasses.field(metadata={"static": True})
    band: int = dataclasses.field(metadata={"static": True})
    halo: int = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})


def partition_csr_halo_ring(csr: CSR, n_shards: int,
                            halo: int) -> RingHaloCSR:
    """Row-partition split into owned/halo column blocks (see above).

    Same locality contract as :func:`partition_csr_halo`: raises if any
    entry reaches beyond ``halo`` columns outside its shard's x band.
    """
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_rows = -(-rows // n_shards)
    band = -(-cols // n_shards)
    if halo > band:
        raise ValueError(f"halo {halo} larger than band {band}")
    own, hal = [], []
    for s in range(n_shards):
        r0, r1 = s * local_rows, min((s + 1) * local_rows, rows)
        sub = sp[r0:r1].tocoo()
        c0 = s * band
        lo, hi = c0 - halo, c0 + band + halo
        if sub.nnz:
            cmin, cmax = int(sub.col.min()), int(sub.col.max())
            if cmin < lo or cmax >= hi:
                raise ValueError(
                    f"shard {s}: columns [{cmin}, {cmax}] exceed halo window "
                    f"[{lo}, {hi}) — matrix is not {halo}-local"
                )
        in_band = (sub.col >= c0) & (sub.col < c0 + band)
        own.append((sub.row[in_band], sub.col[in_band] - c0,
                    sub.data[in_band]))
        hc = sub.col[~in_band]
        # frame = (left halo | right halo), width 2*halo
        hf = np.where(hc < c0, hc - (c0 - halo), halo + hc - (c0 + band))
        hal.append((sub.row[~in_band], hf, sub.data[~in_band]))
    cap_o = max(max(len(o[0]) for o in own), 1)
    cap_h = max(max(len(h[0]) for h in hal), 1)

    def _stack(parts, cap, width_pad_row):
        idx = np.zeros((n_shards, cap), np.int64)
        dat = np.zeros((n_shards, cap), sp.data.dtype)
        rid = np.full((n_shards, cap), width_pad_row, np.int64)
        for s, (rr, cc, vv) in enumerate(parts):
            k = len(rr)
            idx[s, :k] = cc
            dat[s, :k] = vv
            rid[s, :k] = rr
        return idx, dat, rid

    oi, od, orr = _stack(own, cap_o, local_rows)
    hi_, hd, hr = _stack(hal, cap_h, local_rows)
    idt = default_index_dtype
    return RingHaloCSR(
        own_indices=jnp.asarray(oi, idt),
        own_data=jnp.asarray(od),
        own_rows=jnp.asarray(orr, idt),
        halo_indices=jnp.asarray(hi_, idt),
        halo_data=jnp.asarray(hd),
        halo_rows=jnp.asarray(hr, idt),
        shape=(rows, cols),
        n_shards=n_shards,
        local_rows=local_rows,
        band=band,
        halo=halo,
        nnz=csr.nnz,
    )


def shard_halo_ring(part: RingHaloCSR, mesh: Mesh,
                    axis_name: str = "shard"):
    spec = NamedSharding(mesh, P(axis_name))
    return dataclasses.replace(
        part,
        **{f: jax.device_put(getattr(part, f), spec)
           for f in ("own_indices", "own_data", "own_rows",
                     "halo_indices", "halo_data", "halo_rows")},
    )


def dist_spmv_halo_ring(part: RingHaloCSR, x, mesh: Mesh,
                        axis_name: str = "shard"):
    """``y = A @ x`` with the halo exchange overlapped by the owned-block
    matvec (no data dependency between them — see the section comment)."""
    n = part.n_shards
    h = part.halo
    band = part.band
    x_pad = jnp.zeros((n * band,), x.dtype).at[: x.shape[0]].set(x)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name),) * 7,
        out_specs=P(axis_name),
    )
    def run(oi, od, orr, hi_, hd, hr, x_local):
        # 1. collectives first: the transfer starts immediately
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        from_left = jax.lax.ppermute(x_local[-h:], axis_name, fwd)
        from_right = jax.lax.ppermute(x_local[:h], axis_name, bwd)
        # 2. owned partial — independent of the collectives (overlapped)
        y = jax.ops.segment_sum(od[0] * x_local[oi[0]], orr[0],
                                num_segments=part.local_rows)
        # 3. halo partial once the halos land
        frame = jnp.concatenate([from_left, from_right])
        y = y + jax.ops.segment_sum(hd[0] * frame[hi_[0]], hr[0],
                                    num_segments=part.local_rows)
        return y

    y = run(part.own_indices, part.own_data, part.own_rows,
            part.halo_indices, part.halo_data, part.halo_rows, x_pad)
    return y.reshape(-1)[: part.shape[0]]


# ---------------------------------------------------------------------------
# Variable-width halos: per-shard (h_l, h_r) sized to the actual column
# reach, exchanged with ``jax.lax.ragged_all_to_all`` so each link carries
# exactly the bytes its receiver needs (the ragged-halo capability of the
# north star, SURVEY §2.4/§5).  XLA:CPU has no ragged-all-to-all kernel, so
# a ppermute fallback pads every link to the max halo — same frame layout,
# same results, only the exchanged byte count differs (reported by
# ``ragged_bytes``/``padded_bytes`` for the scaling accounting).
# ---------------------------------------------------------------------------


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class VarHaloPartitionedCSR:
    indices: jnp.ndarray  # (n_shards, cap) frame-local col ids
    data: jnp.ndarray  # (n_shards, cap)
    row_ids: jnp.ndarray  # (n_shards, cap)
    h_l: jnp.ndarray  # (n_shards,) left-halo widths
    h_r: jnp.ndarray  # (n_shards,)
    in_off: jnp.ndarray  # (n_shards, n_shards) ragged-a2a send offsets
    send_sz: jnp.ndarray  # (n_shards, n_shards)
    out_off: jnp.ndarray  # (n_shards, n_shards) receiver-frame offsets
    recv_sz: jnp.ndarray  # (n_shards, n_shards)
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    n_shards: int = dataclasses.field(metadata={"static": True})
    local_rows: int = dataclasses.field(metadata={"static": True})
    band: int = dataclasses.field(metadata={"static": True})
    hmax_l: int = dataclasses.field(metadata={"static": True})
    hmax_r: int = dataclasses.field(metadata={"static": True})
    nnz: int = dataclasses.field(metadata={"static": True})

    @property
    def ragged_bytes(self) -> int:
        """Halo bytes moved per exchange with the ragged collective."""
        import numpy as _np

        return int((_np.asarray(self.h_l).sum() + _np.asarray(self.h_r).sum())
                   * _np.dtype(self.data.dtype).itemsize)

    @property
    def padded_bytes(self) -> int:
        """Halo bytes if every link is padded to the max width."""
        import numpy as _np

        return int(self.n_shards * (self.hmax_l + self.hmax_r)
                   * _np.dtype(self.data.dtype).itemsize)


def partition_csr_halo_var(csr: CSR, n_shards: int) -> VarHaloPartitionedCSR:
    """Row-partition with per-shard halo widths measured from the actual
    column reach (no fixed ``halo`` parameter).  Raises if any shard reaches
    beyond its immediate ring neighbors (multi-hop halos unsupported)."""
    sp = csr.to_scipy().tocsr()
    rows, cols = sp.shape
    local_rows = -(-rows // n_shards)
    band = -(-cols // n_shards)
    h_l = np.zeros(n_shards, np.int64)
    h_r = np.zeros(n_shards, np.int64)
    shards = []
    for s in range(n_shards):
        r0, r1 = s * local_rows, min((s + 1) * local_rows, rows)
        sub = sp[r0:r1]
        c0 = s * band
        if sub.nnz:
            cmin, cmax = int(sub.indices.min()), int(sub.indices.max())
            h_l[s] = max(c0 - cmin, 0)
            h_r[s] = max(cmax + 1 - (c0 + band), 0)
            if h_l[s] > band or h_r[s] > band:
                raise ValueError(
                    f"shard {s}: halo ({h_l[s]}, {h_r[s]}) exceeds band "
                    f"{band} — columns reach beyond ring neighbors"
                )
        shards.append((r0, sub, c0))
    hmax_l = max(int(h_l.max()), 1)  # ≥1 keeps frame shapes nonzero
    hmax_r = max(int(h_r.max()), 1)
    cap = max(max(int(sub.nnz) for _, sub, _ in shards), 1)
    n_idx = np.zeros((n_shards, cap), np.int64)
    n_dat = np.zeros((n_shards, cap), sp.data.dtype)
    n_rid = np.full((n_shards, cap), local_rows, np.int64)
    for s, (r0, sub, c0) in enumerate(shards):
        k = int(sub.nnz)
        n_idx[s, :k] = sub.indices - (c0 - hmax_l)  # fixed frame layout
        n_dat[s, :k] = sub.data
        n_rid[s, :k] = np.repeat(np.arange(sub.shape[0]), np.diff(sub.indptr))
    # ragged-a2a tables: device s sends its right edge to s+1's left halo,
    # its left edge to s-1's right halo, and its whole band to itself
    io = np.zeros((n_shards, n_shards), np.int64)
    ss = np.zeros((n_shards, n_shards), np.int64)
    oo = np.zeros((n_shards, n_shards), np.int64)
    rs = np.zeros((n_shards, n_shards), np.int64)
    for s in range(n_shards):
        ss[s, s] = band
        io[s, s] = 0
        oo[s, s] = hmax_l
        rs[s, s] = band
        if s + 1 < n_shards and h_l[s + 1] > 0:
            ss[s, s + 1] = h_l[s + 1]
            io[s, s + 1] = band - h_l[s + 1]
            oo[s, s + 1] = hmax_l - h_l[s + 1]
            rs[s + 1, s] = h_l[s + 1]
        if s - 1 >= 0 and h_r[s - 1] > 0:
            ss[s, s - 1] = h_r[s - 1]
            io[s, s - 1] = 0
            oo[s, s - 1] = hmax_l + band
            rs[s - 1, s] = h_r[s - 1]
    idt = default_index_dtype
    i32 = jnp.int32
    return VarHaloPartitionedCSR(
        indices=jnp.asarray(n_idx, idt),
        data=jnp.asarray(n_dat),
        row_ids=jnp.asarray(n_rid, idt),
        h_l=jnp.asarray(h_l, i32),
        h_r=jnp.asarray(h_r, i32),
        in_off=jnp.asarray(io, i32),
        send_sz=jnp.asarray(ss, i32),
        out_off=jnp.asarray(oo, i32),
        recv_sz=jnp.asarray(rs, i32),
        shape=(rows, cols),
        n_shards=n_shards,
        local_rows=local_rows,
        band=band,
        hmax_l=hmax_l,
        hmax_r=hmax_r,
        nnz=csr.nnz,
    )


def dist_spmv_halo_var(part: VarHaloPartitionedCSR, x, mesh: Mesh,
                       axis_name: str = "shard",
                       use_ragged: bool | None = None):
    """``y = A @ x`` with per-shard variable halos.

    ``use_ragged=None`` follows ``config.ragged_halo()``: the GPU runs
    ``ragged_all_to_all``, the CPU the padded ppermute (XLA:CPU lacks the
    ragged kernel)."""
    if use_ragged is None:
        from ..config import config

        use_ragged = config.ragged_halo()
    n = part.n_shards
    band = part.band
    hmax_l, hmax_r = part.hmax_l, part.hmax_r
    frame = hmax_l + band + hmax_r
    x_pad = jnp.zeros((n * band,), x.dtype).at[: x.shape[0]].set(x)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name),) * 8,
        out_specs=P(axis_name),
    )
    def run(indices, data, row_ids, x_local, io, ss, oo, rs):
        if use_ragged:
            out = jnp.zeros((frame,), x_local.dtype)
            x_frame = jax.lax.ragged_all_to_all(
                x_local, out, io[0], ss[0], oo[0], rs[0],
                axis_name=axis_name)
        else:
            from_left = jax.lax.ppermute(
                x_local[-hmax_l:], axis_name,
                [(i, (i + 1) % n) for i in range(n)])
            from_right = jax.lax.ppermute(
                x_local[:hmax_r], axis_name,
                [(i, (i - 1) % n) for i in range(n)])
            x_frame = jnp.concatenate([from_left, x_local, from_right])
        prod = data[0] * x_frame[indices[0]]
        return jax.ops.segment_sum(prod, row_ids[0],
                                   num_segments=part.local_rows)

    y = run(part.indices, part.data, part.row_ids, x_pad,
            part.in_off, part.send_sz, part.out_off, part.recv_sz)
    return y.reshape(-1)[: part.shape[0]]
