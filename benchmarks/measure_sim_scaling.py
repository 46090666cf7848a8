#!/usr/bin/env python
"""MEASURED (simulated-mesh) scaling evidence on 1/2/4/8 virtual CPU
devices.

A virtual CPU mesh shares one host's cores, so raw weak-scaling times
mostly measure host serialization (total work grows with device count on
fixed silicon) — reporting those as "efficiency" would be dishonest.
What the simulated mesh CAN measure is the **collective overhead**: the
difference between the full distributed op and its local-compute twin
(same shard_map, collective replaced by a zero-comm equivalent).  The
model (parallel/scaling.py) predicts comm bytes growing ~linearly with
device count; these rows validate that SHAPE with measured deltas.

Run (CPU only — uses no card):
    python benchmarks/measure_sim_scaling.py
writes benchmarks/pass_sim_scaling.json (mergeable by merge_results.py).
"""
import functools
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _force_devices(n=8):
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()


_force_devices()

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from sparsematrix_tpu.formats import CSR  # noqa: E402
from sparsematrix_tpu.parallel import dist_spmv, partition_csr_rows  # noqa: E402
from sparsematrix_tpu.parallel.dist_ops import _local_spmv, _pad_vec, _band  # noqa: E402
from sparsematrix_tpu.parallel.scaling import spmv_row_cost  # noqa: E402

BASE_ROWS = 4096
NNZ_ROW = 64
REPS = 40


def _build(rows, rng):
    r = np.repeat(np.arange(rows), NNZ_ROW)
    c = rng.integers(0, rows, rows * NNZ_ROW)
    import scipy.sparse as sps

    v = rng.normal(size=rows * NNZ_ROW).astype(np.float32)
    sp = sps.coo_matrix((v, (r, c)), shape=(rows, rows)).tocsr()
    sp.sum_duplicates()
    return CSR.from_scipy(sp)


def _time(f, *args):
    jax.block_until_ready(f(*args))
    best = np.inf
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _local_twin(part, mesh, axis_name="shard"):
    """dist_spmv's row-partition body with the all_gather replaced by a
    broadcasted (replicated) x — identical local compute, zero comm."""
    n = part.n_shards

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axis_name), P(None)),
                       out_specs=P(axis_name))
    def run(p_local, x_full):
        ip, ix, dd, rid = part.local_csr_arrays(p_local)
        return _local_spmv(ip, ix, dd, rid, x_full[: part.shape[1]],
                           part.local_rows)

    return run


def main():
    rng = np.random.default_rng(11)
    devs = jax.devices()
    assert len(devs) >= 8, devs
    rows_out = []
    for nd in (1, 2, 4, 8):
        rows = BASE_ROWS * nd
        A = _build(rows, rng)
        part = partition_csr_rows(A, nd)
        mesh = Mesh(np.array(devs[:nd]), ("shard",))
        x = jnp.asarray(rng.normal(size=rows).astype(np.float32))
        x_pad = _pad_vec(x, nd * _band(rows, nd))

        f_full = jax.jit(lambda p, v, m=mesh: dist_spmv(p, v, m))
        twin = _local_twin(part, mesh)
        f_local = jax.jit(lambda p, v: twin(p, v))

        t_full = _time(f_full, part, x)
        t_local = _time(f_local, part, x_pad)
        overhead_ms = max(t_full - t_local, 0.0) * 1e3
        model = spmv_row_cost(rows, rows, A.nnz, nd)
        rows_out.append({
            "name": f"weak_scaling/sim-overhead-{nd}dev",
            "shape": (f"rows={rows},nnz/row={NNZ_ROW},"
                      f"comm={model.comm_bytes_per_device}B,"
                      "SIMULATED cpu mesh"),
            "min_ms": overhead_ms,
            "mean_ms": overhead_ms,
            "gnnz_per_s": 0.0,
            "sol_frac": None,
            "checked": None,
            "nnz": A.nnz,
            "extras": {
                "simulated": True,
                "n_devices": nd,
                "t_full_ms": t_full * 1e3,
                "t_local_ms": t_local * 1e3,
                "model_comm_bytes_per_device": int(
                    model.comm_bytes_per_device),
            },
        })
        print(f"{nd}dev rows={rows}: full {t_full*1e3:.2f} ms, local "
              f"{t_local*1e3:.2f} ms, collective overhead "
              f"{overhead_ms:.2f} ms, model comm/dev "
              f"{model.comm_bytes_per_device}B", flush=True)
    out = pathlib.Path(__file__).resolve().parent / "pass_sim_scaling.json"
    with open(out, "w") as fh:
        json.dump(rows_out, fh, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
