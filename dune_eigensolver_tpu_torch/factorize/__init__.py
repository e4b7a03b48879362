from dune_eigensolver_tpu_torch.factorize.cg import (
    cg_inverse_factory,
    cg_solve,
    cg_solve_t,
)
from dune_eigensolver_tpu_torch.factorize.multigrid import mg_inverse_factory

__all__ = ["cg_inverse_factory", "cg_solve", "cg_solve_t", "mg_inverse_factory"]
