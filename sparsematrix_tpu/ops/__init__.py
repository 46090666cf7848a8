from .spmv import prepare_spmv, spmv, spmv_reference
from .spmm import spmm, spmm_reference, spmm_right, spmm_densify
from .addmatmat import add_mat_mat
from .spgemm import (SpGEMMPlan, spgemm, spgemm_apply, spgemm_densify,
                     spgemm_extract, spgemm_plan)
from .trisolve import (
    TriFixPlan,
    TriSolvePlan,
    trisolve,
    trisolve_apply,
    trisolve_fixpoint_apply,
    trisolve_fixpoint_plan,
    trisolve_plan,
)
from .ichol import ic0, ic0_fixpoint_plans, ic0_plans, ic_apply
from .direct import SpluSolver, splu_plans, splu_solve
from .ilu import ilu0, ilu0_fixpoint_plans, ilu0_plans, ilu_apply
from .transpose_ops import csr_transpose_device, spmv_t, spmm_t
from .quantized import (QuantizedCodebookDense, add_mat_mat_int8,
                        add_mat_mat_int16, quantize_codebook)
from .permute import PermutePlan, apply_permutation, plan_gather_permutation
from .spmm_lowdeg import SlicedEllMM, pack_sliced_ell, spmm_sliced_ell
from .add import SparseAddPlan, sparse_add, sparse_add_apply, sparse_add_plan
from .elementwise import scale, axpy_same_pattern, diagonal, frobenius_norm, with_data

__all__ = [
    "spmv",
    "prepare_spmv",
    "spmv_reference",
    "spmm",
    "spmm_reference",
    "spmm_right",
    "spmm_densify",
    "add_mat_mat",
    "SpGEMMPlan",
    "spgemm",
    "spgemm_densify",
    "spgemm_extract",
    "spgemm_apply",
    "spgemm_plan",
    "TriSolvePlan",
    "trisolve",
    "trisolve_apply",
    "trisolve_plan",
    "TriFixPlan",
    "trisolve_fixpoint_apply",
    "trisolve_fixpoint_plan",
    "ic0",
    "ic0_plans",
    "ic0_fixpoint_plans",
    "ic_apply",
    "SpluSolver",
    "splu_plans",
    "splu_solve",
    "ilu0",
    "ilu0_plans",
    "ilu0_fixpoint_plans",
    "ilu_apply",
    "spmv_t",
    "csr_transpose_device",
    "QuantizedCodebookDense",
    "add_mat_mat_int8",
    "add_mat_mat_int16",
    "quantize_codebook",
    "spmm_t",
    "scale",
    "axpy_same_pattern",
    "diagonal",
    "frobenius_norm",
    "with_data",
    "SparseAddPlan",
    "sparse_add",
    "sparse_add_apply",
    "sparse_add_plan",
    "PermutePlan",
    "plan_gather_permutation",
    "apply_permutation",
    "SlicedEllMM",
    "pack_sliced_ell",
    "spmm_sliced_ell",
]
