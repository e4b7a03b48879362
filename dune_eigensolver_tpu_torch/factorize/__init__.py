"""Inverse engines: factories that map a (shifted) operand to a multi-RHS
solve, and the routing that picks one by the operand.

Counterpart of the JAX package's ``factorize/__init__.py``: the direct
engines (block-banded ``banded.py``, RCM-banded ``reordered.py``, host
SuperLU with a level-scheduled device solve ``host_lu.py``) and the
iterative ones (Jacobi-CG, Chebyshev, Chebyshev-CG, the multigrid V-cycle
and V-cycle-CG).
"""

from dune_eigensolver_tpu_torch.factorize.banded import (
    BANDED_BW_MAX,
    BandedFactorization,
    banded_factorization_from_numpy,
    banded_inverse_factory,
    banded_solve,
    factorize_banded,
    factorize_banded_device,
)
from dune_eigensolver_tpu_torch.factorize.cg import (
    cg_inverse_factory,
    cg_solve,
    cg_solve_t,
)
from dune_eigensolver_tpu_torch.factorize.chebyshev import (
    cheb_cg_inverse_factory,
    chebyshev_apply,
    chebyshev_inverse_factory,
)
from dune_eigensolver_tpu_torch.factorize.host_lu import (
    FactorizedMatrix,
    factorize,
    lu_inverse_factory,
)
from dune_eigensolver_tpu_torch.factorize.multigrid import (
    detect_grid_dims,
    mg_cg_inverse_factory,
    mg_inverse_factory,
)
from dune_eigensolver_tpu_torch.factorize.reordered import (
    rcm_banded_inverse_factory,
    rcm_bandwidth,
)
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix


def default_inverse_factory(A_int, **kw):
    """Pick the shift-invert engine for the operand, as the reference does:

    * DIA with a band of at most ``BANDED_BW_MAX`` (2D stencils: bw = N; 3D
      stencils up to N = 45) -> the block-banded direct engine
      (``banded_inverse_factory``, ``fn.engine == "banded"``);
    * DIA with a wider band (3D stencils: bw = N^2): a structured stencil
      pattern gets V-cycle-preconditioned CG (``mg_cg_inverse_factory(rtol=
      1e-5, maxiter=100)``, an n-independent iteration count), anything
      else Chebyshev-preconditioned CG (``cheb_cg_inverse_factory(rtol=
      1e-5, maxiter=300)``);
    * other formats (ELL, BSR) -> reverse Cuthill-McKee + the banded engine
      (``rcm_banded_inverse_factory``, ``fn.engine == "rcm_banded"``); if
      RCM cannot confine the band to ``BANDED_BW_MAX`` (``ValueError``),
      Chebyshev-CG (1e-5, 300).

    ``kw`` goes to the direct engines. The engine taken shows in the
    returned pair: the direct engines' ``fn.engine`` and their factors'
    ``stats`` = (bw, C, nb, kind), the iterative ones' solve function.
    """
    if isinstance(A_int, DIAMatrix):
        if max(abs(o) for o in A_int.offsets) <= BANDED_BW_MAX:
            return banded_inverse_factory(A_int, **kw)
        if detect_grid_dims(A_int.offsets, A_int.shape[0]) is not None:
            return mg_cg_inverse_factory(rtol=1e-5, maxiter=100)(A_int)
        return cheb_cg_inverse_factory(rtol=1e-5, maxiter=300)(A_int)
    try:
        return rcm_banded_inverse_factory(A_int, **kw)
    except ValueError:
        return cheb_cg_inverse_factory(rtol=1e-5, maxiter=300)(A_int)


def solve_linear_system(A, b):
    """Single-RHS sanity solve through the default engine. Returns x with
    A x = b."""
    import torch

    from dune_eigensolver_tpu_torch.solvers.standard import normalize_inverse

    aux, fn = normalize_inverse(default_inverse_factory(A))
    b = torch.as_tensor(b, dtype=A.dtype, device=A.device)
    with torch.no_grad():
        if getattr(fn, "layout_t", False):
            return fn(aux, b.reshape(1, -1))[0]
        return fn(aux, b.reshape(-1, 1))[:, 0]


__all__ = [
    "solve_linear_system",
    "BANDED_BW_MAX",
    "BandedFactorization",
    "banded_factorization_from_numpy",
    "banded_inverse_factory",
    "banded_solve",
    "factorize_banded",
    "factorize_banded_device",
    "FactorizedMatrix",
    "factorize",
    "lu_inverse_factory",
    "rcm_banded_inverse_factory",
    "rcm_bandwidth",
    "cg_inverse_factory",
    "cg_solve",
    "cg_solve_t",
    "cheb_cg_inverse_factory",
    "chebyshev_apply",
    "chebyshev_inverse_factory",
    "mg_inverse_factory",
    "mg_cg_inverse_factory",
    "default_inverse_factory",
]
