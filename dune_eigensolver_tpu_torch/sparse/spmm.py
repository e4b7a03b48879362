"""Transposed-layout SpMM dispatch: ``Yt (m, n) = (A @ X)^T``.

Counterpart of ``spmm_t`` in the JAX package's ``sparse/spmm.py``. The
solver state is the transposed multivector (m, n), the layout the DIA
kernel streams. A DIA operand on a CUDA tensor runs the hand-written CUDA
kernel; on a CPU tensor it runs the kernel's plain PyTorch version. The
ELL and BSR containers are not ported yet, so any other operand type
raises ``TypeError``, as the reference does for unknown types.
"""

from __future__ import annotations

import torch

from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
    dia_spmm_t_cuda,
    dia_spmm_t_reference,
)
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix


def spmm_t(A, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T for a DIA operand; Xt is (m, n). A CUDA tensor
    launches the kernel (which raises on what it cannot take), CPU
    operands take the plain version; nothing falls back between them."""
    if not isinstance(A, DIAMatrix):
        raise TypeError(f"spmm_t: unsupported operand type {type(A)}")
    if Xt.is_cuda:
        return dia_spmm_t_cuda(A, Xt)
    if Xt.device.type == "cpu" and A.data.device.type == "cpu":
        return dia_spmm_t_reference(A, Xt)
    raise ValueError(f"spmm_t: operands on {A.data.device} and {Xt.device}")
