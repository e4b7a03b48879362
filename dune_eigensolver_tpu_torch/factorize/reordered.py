"""Bandwidth-reduced direct solve for general sparse operands.

Counterpart of the JAX package's ``factorize/reordered.py``: reverse
Cuthill-McKee confines an ELL/BSR operand to a band, and the block-banded
engine (``factorize/banded.py``) factorizes and solves the permuted
operator: ``A x = b  <=>  (P A P^T)(P x) = P b``.

One difference from the reference, on purpose: the reference refines with a
product by the permuted operator in DIA form, which for an RCM-ordered
elasticity or graph operand has hundreds of distinct diagonals, more than
the DIA kernel takes (16). Here the DIA form feeds the factorization only,
and the refinement residual multiplies by the permuted operator in the
operand's own container (ELL -> K2, BSR -> K3 on the card): the same
operator, summed in another order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dune_eigensolver_tpu_torch.factorize.banded import (
    BANDED_BW_MAX,
    factorize_banded_device,
    refined_solve_fn,
)
from dune_eigensolver_tpu_torch.solvers.engine import make_engine
from dune_eigensolver_tpu_torch.sparse.formats import (
    BSRMatrix,
    bsr_from_scipy,
    dia_from_scipy,
    ell_from_scipy,
)
from dune_eigensolver_tpu_torch.utils.device import resolve


def _to_scipy_csr(A):
    import scipy.sparse as sp

    if hasattr(A, "to_scipy"):
        return sp.csr_matrix(A.to_scipy())
    return sp.csr_matrix(A)


def _bandwidth(S) -> int:
    coo = S.tocoo()
    return int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0


def rcm_bandwidth(A) -> Tuple[np.ndarray, int]:
    """(permutation, bandwidth after RCM) for any sparse operand."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = _to_scipy_csr(A)
    perm = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True))
    return perm, _bandwidth(S[perm][:, perm])


def rcm_banded_inverse_factory(
    A,
    C: int = 256,
    dtype=None,
    refine: int = 1,
    perm: Optional[np.ndarray] = None,
    device=None,
    **kw,
):
    """(aux, fn) pair solving with the banded engine on the RCM-permuted
    operator. Raises ValueError if the reduced bandwidth is still wider
    than ``BANDED_BW_MAX`` (the caller falls back to an iterative engine).

    ``A``: a port container or a scipy matrix; ``dtype`` (torch) and
    ``device`` default to the container's (for scipy input: its dtype and
    the current CUDA device). ``kw`` goes to the factorization. ``fn`` takes
    and returns the transposed (m, n) layout (``layout_t``),
    ``fn.engine == "rcm_banded"``, and ``aux = (F, A_res, perm, iperm)``
    with ``F.stats`` = (bw, C, nb, kind) and ``A_res`` the permuted operand
    the refinement multiplies by."""
    S = _to_scipy_csr(A)
    if perm is None:
        perm, bw = rcm_bandwidth(S)
    else:
        bw = _bandwidth(S[perm][:, perm])
    if bw > BANDED_BW_MAX:
        raise ValueError(
            f"rcm_banded_inverse_factory: RCM bandwidth {bw} exceeds "
            f"{BANDED_BW_MAX}; use the CG or host-LU engine"
        )
    if hasattr(A, "device"):
        device = A.device if device is None else device
        dtype = dtype or A.dtype
    else:
        dtype = dtype or torch.from_numpy(np.zeros(0, S.dtype)).dtype
    device = resolve(device)
    Sp = S[perm][:, perm]
    F = factorize_banded_device(dia_from_scipy(Sp, dtype=dtype, device=device), C=C, **kw)
    if isinstance(A, BSRMatrix):
        A_res = bsr_from_scipy(Sp, block=A.block, dtype=dtype, device=device)
    else:
        A_res = ell_from_scipy(Sp, dtype=dtype, device=device)
    A_res = make_engine(A_res)[0]
    perm_d = torch.as_tensor(perm.astype(np.int64), device=device)
    iperm_d = torch.as_tensor(np.argsort(perm).astype(np.int64), device=device)
    return (F, A_res, perm_d, iperm_d), _rcm_solve_fn(int(refine))


def _rcm_solve_fn(refine: int):
    inner = refined_solve_fn(refine)

    def solve(aux, Xt):
        F, A_res, p, ip = aux
        return inner((F, A_res), Xt.index_select(1, p)).index_select(1, ip)

    solve.layout_t = True
    solve.engine = "rcm_banded"
    return solve


__all__ = ["rcm_bandwidth", "rcm_banded_inverse_factory"]
