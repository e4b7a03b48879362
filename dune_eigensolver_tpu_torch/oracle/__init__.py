from dune_eigensolver_tpu_torch.oracle.analytic import (
    eigenvalues_laplace_dirichlet_2d,
    eigenvalues_laplace_dirichlet_3d,
)

__all__ = [
    "eigenvalues_laplace_dirichlet_2d",
    "eigenvalues_laplace_dirichlet_3d",
]
