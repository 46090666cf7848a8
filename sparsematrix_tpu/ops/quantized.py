"""Integer-activation GEMM — the ``wgemm_plus`` capability.

The reference's vendored OpenBLAS fork ships a non-standard int16
activation GEMM (``cblas_wgemm_plus``,
reference openblas_darwin_plus/include/cblas.h:252-257) so quantized
activations can multiply the codebook-quantized weights without an fp32
blow-up.  The analogue here is an int8 product: activations
are quantized per-tensor to int8, the ≤255-entry codebook is quantized to
int8 once at build time, the contraction runs int8×int8→int32, and one
scalar rescale recovers the fp32 result.

Accuracy model: the codebook already restricts weights to ≤255 distinct
values, so an 8-bit weight grid loses little; activations get the usual
per-tensor symmetric int8 error (~0.4 % of the dynamic range) — well
inside the reference's own 0.1 relative oracle tolerance
(blas_test.h:163-173).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.codebook_dense import CodebookDense

__all__ = ["QuantizedCodebookDense", "quantize_codebook",
           "add_mat_mat_int8", "add_mat_mat_int16"]

import dataclasses

from ..formats.base import register_sparse_pytree


@register_sparse_pytree
@dataclasses.dataclass(frozen=True)
class QuantizedCodebookDense:
    """Codebook matrix with an int8-quantized table (built once)."""

    idx: jnp.ndarray  # (rows, cols) uint8
    q_table: jnp.ndarray  # (table_size+1,) int8, sentinel 0
    scale: jnp.ndarray  # () fp32 — table dequant scale
    shape: Tuple[int, int] = dataclasses.field(metadata={"static": True})
    table_size: int = dataclasses.field(metadata={"static": True})

    @property
    def q_dense(self):
        """int8 dense weight matrix (gathered once per call; XLA caches
        the gather across jit invocations of the same graph)."""
        return self.q_table[self.idx]


def quantize_codebook(B: CodebookDense) -> QuantizedCodebookDense:
    """Quantize the value table to int8 (symmetric, per-tensor)."""
    table = np.asarray(B.val_table)
    amax = float(np.abs(table).max())
    scale = amax / 127.0 if amax > 0 else 1.0
    q = np.clip(np.round(table / scale), -127, 127).astype(np.int8)
    q[-1] = 0  # sentinel stays exactly zero
    return QuantizedCodebookDense(
        idx=B.idx,
        q_table=jnp.asarray(q),
        scale=jnp.float32(scale),
        shape=B.shape,
        table_size=B.table_size,
    )


def add_mat_mat_int8(a, b_t_q: QuantizedCodebookDense, c=None,
                     alpha=1.0, beta=0.0):
    """``beta*C + alpha * A @ B`` with int8 activations × int8 codebook.

    ``b_t_q`` stores B^T (the SblasTrans convention, blas_test.h:145).
    A is quantized per-tensor symmetric; the contraction accumulates in
    int32; one fused rescale restores fp32.
    """
    if beta != 0 and c is None:
        raise ValueError("add_mat_mat_int8: beta != 0 requires c")
    a = jnp.asarray(a)
    a_amax = jnp.maximum(jnp.max(jnp.abs(a)), 1e-30)
    a_scale = a_amax / 127.0
    aq = jnp.clip(jnp.round(a / a_scale), -127, 127).astype(jnp.int8)
    bq = b_t_q.q_dense  # (n, k) int8
    prod_i32 = jax.lax.dot_general(
        aq, bq, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (m, n)
    out = (alpha * a_scale * b_t_q.scale) * prod_i32.astype(jnp.float32)
    if c is not None:
        out = out + beta * jnp.asarray(c)
    return out


def add_mat_mat_int16(a, b_t_q: QuantizedCodebookDense, c=None,
                      alpha=1.0, beta=0.0):
    """``beta*C + alpha * A @ B`` with int16 activations × int8 codebook
    — the direct ``cblas_wgemm_plus`` analogue
    (reference openblas_darwin_plus/include/cblas.h:252-257).

    The integer product is int8×int8→int32, so the int16
    activation is double-pumped as two int8 planes:

        a16 = 256·hi + (lo' + 128),  hi, lo' ∈ [-128, 127]
        A@B = 256·(hi@B) + lo'@B + 128·colsum(B)

    Two int8 products (2× the int8 cost) buy a 256× finer activation grid;
    each int8 partial stays well inside int32 (≤ k·127² ≈ 33 M at the
    reference k=2047) and the fp32 recombination is exact to ≤2 ulp.
    """
    if beta != 0 and c is None:
        raise ValueError("add_mat_mat_int16: beta != 0 requires c")
    a = jnp.asarray(a)
    a_amax = jnp.maximum(jnp.max(jnp.abs(a)), 1e-30)
    a_scale = a_amax / 32767.0
    aq = jnp.clip(jnp.round(a / a_scale), -32767, 32767).astype(jnp.int32)
    hi = (aq >> 8).astype(jnp.int8)                   # floor-div: -128..127
    lo = (aq - (aq >> 8 << 8) - 128).astype(jnp.int8)  # residual-128
    bq = b_t_q.q_dense  # (n, k) int8
    dims = (((1,), (1,)), ((), ()))
    p_hi = jax.lax.dot_general(hi, bq, dims,
                               preferred_element_type=jnp.int32)
    p_lo = jax.lax.dot_general(lo, bq, dims,
                               preferred_element_type=jnp.int32)
    colsum = jnp.sum(bq.astype(jnp.int32), axis=1)  # (n,)
    prod = (256.0 * p_hi.astype(jnp.float32) + p_lo.astype(jnp.float32)
            + 128.0 * colsum.astype(jnp.float32)[None, :])
    out = (alpha * a_scale * b_t_q.scale) * prod
    if c is not None:
        out = out + beta * jnp.asarray(c)
    return out
