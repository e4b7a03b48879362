from dune_eigensolver_tpu_torch.sparse.formats import (
    BSRMatrix,
    DIAMatrix,
    ELLMatrix,
    bsr_from_numpy,
    bsr_from_scipy,
    dia_from_numpy,
    dia_from_scipy,
    ell_from_numpy,
    ell_from_scipy,
)
from dune_eigensolver_tpu_torch.sparse.reorder import rcm_pencil, unpermute_vectors
from dune_eigensolver_tpu_torch.sparse.spmm import spmm, spmm_t

__all__ = [
    "BSRMatrix",
    "DIAMatrix",
    "ELLMatrix",
    "bsr_from_numpy",
    "bsr_from_scipy",
    "dia_from_numpy",
    "dia_from_scipy",
    "ell_from_numpy",
    "ell_from_scipy",
    "rcm_pencil",
    "spmm",
    "spmm_t",
    "unpermute_vectors",
]
