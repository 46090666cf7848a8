"""Roofline accounting: memory-traffic models per op/format → speed-of-
light nnz/s on the device, so measured numbers can be reported as a share
of the bound.

Sparse ops are memory-bound (like the reference's AXPY stream, SURVEY §6:
~16 GFLOP/s on a CPU that does hundreds dense); the ceiling is the bytes
moved, not FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ChipSpec", "CHIPS", "chip_spec", "spmv_csr_bytes", "spmm_bytes",
           "speed_of_light_nnz_s"]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # device-memory bandwidth GB/s
    bf16_tflops: float  # dense tensor-core rate
    tf32_tflops: float
    fp32_tflops: float  # outside the tensor cores


# Published peaks, keyed by ``jax.Device.device_kind``.  H100 SXM: NVIDIA's
# data sheet, dense rates without sparsity, at the full 700 W limit.
CHIPS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(name="H100 SXM", hbm_gbps=3350.0,
                                      bf16_tflops=989.0, tf32_tflops=495.0,
                                      fp32_tflops=67.0),
}


def chip_spec(device_kind: str | None = None) -> ChipSpec:
    """The roofline entry for ``device_kind`` (default: the first JAX
    device).  A device that is not in the table is an error."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return CHIPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no roofline entry for device kind {device_kind!r}; known: "
            f"{sorted(CHIPS)}") from None


def spmv_csr_bytes(nnz: int, rows: int, cols: int, val_bytes: int = 4,
                   idx_bytes: int = 4) -> int:
    """Minimum memory traffic for CSR SpMV: read data + indices + x once,
    write y once.  (x re-reads due to random access are excluded — this is
    the optimistic speed-of-light.)"""
    return nnz * (val_bytes + idx_bytes) + cols * val_bytes + rows * val_bytes


def spmm_bytes(nnz: int, rows: int, cols: int, k: int, val_bytes: int = 4,
               idx_bytes: int = 4, stored_block_waste: float = 1.0) -> int:
    """Minimum memory traffic for SpMM vs k dense RHS columns.
    ``stored_block_waste`` ≥ 1 inflates matrix bytes for padded block
    layouts (blocked-ELL stores zero-filled blocks)."""
    matrix = int(nnz * (val_bytes + idx_bytes) * stored_block_waste)
    rhs = cols * k * val_bytes
    out = rows * k * val_bytes
    return matrix + rhs + out


def speed_of_light_nnz_s(nnz: int, traffic_bytes: int,
                         chip: ChipSpec | None = None) -> float:
    """nnz/s if the op ran at the device's full memory bandwidth
    (``chip`` defaults to the running device's table entry)."""
    if chip is None:
        chip = chip_spec()
    seconds = traffic_bytes / (chip.hbm_gbps * 1e9)
    return nnz / seconds
