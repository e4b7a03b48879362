from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
    dia_spmm_t_cuda,
    dia_spmm_t_reference,
)

__all__ = ["dia_spmm_t_cuda", "dia_spmm_t_reference"]
