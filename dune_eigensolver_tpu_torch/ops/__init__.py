from dune_eigensolver_tpu_torch.ops.ortho import (
    b_orthonormalize_blocked_t,
    dot_products_all,
    dot_products_diagonal,
    dot_products_diagonal_t,
    orthonormalize_blocked,
    orthonormalize_blocked_t,
)

__all__ = [
    "b_orthonormalize_blocked_t",
    "dot_products_all",
    "dot_products_diagonal",
    "dot_products_diagonal_t",
    "orthonormalize_blocked",
    "orthonormalize_blocked_t",
]
