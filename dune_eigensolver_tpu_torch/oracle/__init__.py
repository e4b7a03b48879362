from dune_eigensolver_tpu_torch.oracle.analytic import (
    eigenvalues_laplace_dirichlet_2d,
    eigenvalues_laplace_dirichlet_3d,
)
from dune_eigensolver_tpu_torch.oracle.scipy_oracle import (
    largest_standard,
    smallest_generalized,
    smallest_generalized_nonsym,
    smallest_standard,
    smallest_standard_nonsym,
)

__all__ = [
    "eigenvalues_laplace_dirichlet_2d",
    "eigenvalues_laplace_dirichlet_3d",
    "largest_standard",
    "smallest_generalized",
    "smallest_generalized_nonsym",
    "smallest_standard",
    "smallest_standard_nonsym",
]
