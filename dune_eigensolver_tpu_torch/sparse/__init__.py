from dune_eigensolver_tpu_torch.sparse.formats import (
    DIAMatrix,
    dia_from_numpy,
    dia_from_scipy,
)
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

__all__ = ["DIAMatrix", "dia_from_numpy", "dia_from_scipy", "spmm_t"]
