"""sparsematrix_tpu — a sparse linear-algebra framework for JAX.

Built from scratch in JAX/XLA with the capabilities of
NeverLEX/sparsematrix (codebook-quantized sparse GEMM) generalized to a full
sparse stack: COO/CSR/BSR/ELL/BlockedELL/Codebook formats, SpMV, SpMM,
SpGEMM, triangular solve, ILU(0), and multi-device distribution via
``jax.sharding`` + ``shard_map``.
"""
from .version import __version__
from .config import config
from . import formats, ops, parallel, solvers, io
from .formats import (
    COO,
    CSR,
    BSR,
    ELL,
    BlockedELL,
    CodebookCSR,
)
from .ops import spmv, spmm, spmm_right, add_mat_mat

__all__ = [
    "__version__",
    "config",
    "formats",
    "ops",
    "COO",
    "CSR",
    "BSR",
    "ELL",
    "BlockedELL",
    "CodebookCSR",
    "spmv",
    "spmm",
    "spmm_right",
    "add_mat_mat",
]
