"""Transposed-layout SpMM dispatch: ``Yt (m, n) = (A @ X)^T``.

Counterpart of ``spmm_t`` in the JAX package's ``sparse/spmm.py``. The
solver state is the transposed multivector (m, n), the layout the kernels
stream. Each container type has a hand-written CUDA kernel and its plain
PyTorch version: a CUDA tensor launches the kernel (which raises on what it
cannot take), CPU operands take the plain version, and nothing falls back
between them. Any other operand type raises ``TypeError``, as the
reference does for unknown types.
"""

from __future__ import annotations

import torch

from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
    dia_spmm_t_cuda,
    dia_spmm_t_reference,
)
from dune_eigensolver_tpu_torch.kernels.gather_spmm import (
    bsr_spmm_t_cuda,
    bsr_spmm_t_reference,
    ell_spmm_t_cuda,
    ell_spmm_t_reference,
)
from dune_eigensolver_tpu_torch.sparse.formats import BSRMatrix, DIAMatrix, ELLMatrix

# container type -> (CUDA kernel wrapper, plain version)
_ROUTES = {
    DIAMatrix: (dia_spmm_t_cuda, dia_spmm_t_reference),
    ELLMatrix: (ell_spmm_t_cuda, ell_spmm_t_reference),
    BSRMatrix: (bsr_spmm_t_cuda, bsr_spmm_t_reference),
}


def spmm_t(A, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T for a DIA, ELL or BSR operand; Xt is (m, n)."""
    route = _ROUTES.get(type(A))
    if route is None:
        raise TypeError(f"spmm_t: unsupported operand type {type(A)}")
    kernel, plain = route
    if Xt.is_cuda:
        return kernel(A, Xt)
    if Xt.device.type == "cpu" and A.device.type == "cpu":
        return plain(A, Xt)
    raise ValueError(f"spmm_t: operands on {A.device} and {Xt.device}")
