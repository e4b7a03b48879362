from dune_eigensolver_tpu_torch.solvers.generalized import generalized_inverse
from dune_eigensolver_tpu_torch.solvers.lobpcg import lobpcg_generalized
from dune_eigensolver_tpu_torch.solvers.nested import lobpcg_nested, prolong_vectors
from dune_eigensolver_tpu_torch.solvers.result import EigenResult
from dune_eigensolver_tpu_torch.solvers.standard import standard_inverse, standard_largest

__all__ = [
    "EigenResult",
    "generalized_inverse",
    "lobpcg_generalized",
    "lobpcg_nested",
    "prolong_vectors",
    "standard_inverse",
    "standard_largest",
]
