"""SpMM dispatch: ``spmm_t`` in the transposed layout, ``Yt (m, n) =
(A @ X)^T``, and the column-layout ``spmm``, ``Y (n, m) = A @ X``, over it.

Counterpart of ``spmm_t`` and ``spmm`` (with ``dia_spmm``, ``ell_spmm``,
``bsr_spmm``, ``ell_spmm_t``, ``bsr_spmm_t``) in the JAX package's
``sparse/spmm.py``. The
solver state is the transposed multivector (m, n), the layout the kernels
stream. Each container type has a hand-written CUDA kernel and its plain
PyTorch version: a CUDA tensor launches the kernel (which raises on what it
cannot take), CPU operands take the plain version, and nothing falls back
between them. Any other operand type raises ``TypeError``, as the
reference does for unknown types. In paranoid mode (``utils/paranoid.py``)
each kernel dispatch feeds its output to ``nan_check`` under the kernel's
name, as the JAX package checks its Pallas dispatches.
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
from dune_eigensolver_tpu_torch.utils.paranoid import nan_check

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
        return nan_check(kernel(A, Xt), kernel.__name__)
    if Xt.device.type == "cpu" and A.device.type == "cpu":
        return plain(A, Xt)
    raise ValueError(f"spmm_t: operands on {A.device} and {Xt.device}")


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a DIA, ELL or BSR operand; X is (n, m) tall-skinny, the
    oracle-facing layout. One transposed copy in, ``spmm_t``, a transposed
    view out: on the card it runs the same kernels as the solvers do."""
    if type(A) not in _ROUTES:
        raise TypeError(f"spmm: unsupported operand type {type(A)}")
    if X.ndim != 2 or A.shape[1] != X.shape[0]:
        raise ValueError(f"spmm: shape mismatch {A.shape} @ {tuple(X.shape)}")
    return spmm_t(A, X.T.contiguous()).T


def ell_spmm_t(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T with A in ELL format. Xt: (m, n_cols). K2 on a
    CUDA tensor, its plain version on the CPU (``spmm_t``'s route)."""
    return spmm_t(_expect(A, ELLMatrix, "ell_spmm_t"), Xt)


def bsr_spmm_t(A: BSRMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T with A in block-ELL format. Xt: (m, n_cols). K3 on
    a CUDA tensor, its plain version on the CPU (``spmm_t``'s route)."""
    return spmm_t(_expect(A, BSRMatrix, "bsr_spmm_t"), Xt)


def dia_spmm(A: DIAMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in DIA format. X: (n, m)."""
    return spmm(_expect(A, DIAMatrix, "dia_spmm"), X)


def ell_spmm(A: ELLMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in ELL format. X: (n_cols, m)."""
    return spmm(_expect(A, ELLMatrix, "ell_spmm"), X)


def bsr_spmm(A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A in block-ELL format. X: (n_cols, m)."""
    return spmm(_expect(A, BSRMatrix, "bsr_spmm"), X)


def _expect(A, kind, what):
    if not isinstance(A, kind):
        raise TypeError(f"{what}: expected {kind.__name__}, got {type(A)}")
    return A
