from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
    dia_spmm_t_cuda,
    dia_spmm_t_reference,
    dia_vector_width,
)
from dune_eigensolver_tpu_torch.kernels.gather_spmm import (
    bsr_spmm_t_cuda,
    bsr_spmm_t_reference,
    ell_spmm_t_cuda,
    ell_spmm_t_reference,
)

__all__ = [
    "bsr_spmm_t_cuda",
    "bsr_spmm_t_reference",
    "dia_spmm_t_cuda",
    "dia_spmm_t_reference",
    "dia_vector_width",
    "ell_spmm_t_cuda",
    "ell_spmm_t_reference",
]
