from dune_eigensolver_tpu_torch.solvers.adaptive import generalized_inverse_adaptive
from dune_eigensolver_tpu_torch.solvers.checkpoint import (
    generalized_inverse_checkpointed,
    lobpcg_generalized_checkpointed,
)
from dune_eigensolver_tpu_torch.solvers.generalized import generalized_inverse
from dune_eigensolver_tpu_torch.solvers.lobpcg import lobpcg_generalized
from dune_eigensolver_tpu_torch.solvers.nested import lobpcg_nested, prolong_vectors
from dune_eigensolver_tpu_torch.solvers.refine import refine_eigenpairs
from dune_eigensolver_tpu_torch.solvers.result import EigenResult
from dune_eigensolver_tpu_torch.solvers.standard import standard_inverse, standard_largest

__all__ = [
    "EigenResult",
    "standard_largest",
    "standard_inverse",
    "generalized_inverse",
    "generalized_inverse_adaptive",
    "generalized_inverse_checkpointed",
    "lobpcg_generalized",
    "lobpcg_generalized_checkpointed",
    "lobpcg_nested",
    "prolong_vectors",
    "refine_eigenpairs",
]
