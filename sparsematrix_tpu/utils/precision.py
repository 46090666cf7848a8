"""Precision of the library's dense contractions.

fp32 operands get ``Precision.HIGHEST``: XLA may otherwise run an fp32
product on an H100's tensor cores as TF32, which keeps about three
decimal digits; HIGHEST keeps true fp32.  bf16 and other narrow operands
keep ``DEFAULT``; callers that want fp32 accumulation ask for it with
``preferred_element_type``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["matmul_precision"]


def matmul_precision(dtype):
    """``Precision.HIGHEST`` for fp32 operands, ``DEFAULT`` otherwise."""
    return (jax.lax.Precision.HIGHEST if dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
