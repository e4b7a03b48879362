"""Inverse engines: factories that map a (shifted) operand to a multi-RHS
solve, and the routing that picks one by the operand.

Counterpart of the JAX package's ``factorize/__init__.py``. Ported: the
iterative engines (Jacobi-CG, Chebyshev, Chebyshev-CG, the multigrid
V-cycle and V-cycle-CG). The direct engines (``banded.py``,
``reordered.py``, ``host_lu.py``; ROADMAP queue 1 item 10) are not ported
yet, and ``default_inverse_factory`` raises where the reference takes one.
"""

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
from dune_eigensolver_tpu_torch.factorize.multigrid import (
    detect_grid_dims,
    mg_cg_inverse_factory,
    mg_inverse_factory,
)
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix

#: widest band the reference's banded engine takes (its ``_DEVICE_BW_MAX``)
BANDED_BW_MAX = 2048


def default_inverse_factory(A_int):
    """Pick the shift-invert engine for the operand, as the reference does:

    * DIA with a band of at most ``BANDED_BW_MAX`` (2D stencils: bw = N)
      -> the block-banded direct engine. Not ported yet: raises
      ``NotImplementedError``;
    * DIA with a wider band (3D stencils: bw = N^2): a structured stencil
      pattern gets V-cycle-preconditioned CG (``mg_cg_inverse_factory(rtol=
      1e-5, maxiter=100)``, an n-independent iteration count), anything
      else Chebyshev-preconditioned CG (``cheb_cg_inverse_factory(rtol=
      1e-5, maxiter=300)``);
    * other formats (ELL, BSR) -> reverse Cuthill-McKee + the banded
      engine. Not ported yet: raises ``NotImplementedError``.

    The two refusals do not quietly take an iterative engine instead: that
    would be another default than the reference's. Pass ``inverse=`` /
    ``precond=`` explicitly there (e.g. ``cg_inverse_factory(rtol=1e-5)``).
    """
    if isinstance(A_int, DIAMatrix):
        bw = max(abs(o) for o in A_int.offsets)
        if bw <= BANDED_BW_MAX:
            raise NotImplementedError(
                f"default_inverse_factory: a DIA operand of bandwidth {bw} <= "
                f"{BANDED_BW_MAX} takes the block-banded direct engine "
                "(factorize/banded.py), which is not ported yet (ROADMAP queue 1 "
                "item 10); pass a factory, e.g. cg_inverse_factory(rtol=1e-5)"
            )
        if detect_grid_dims(A_int.offsets, A_int.shape[0]) is not None:
            return mg_cg_inverse_factory(rtol=1e-5, maxiter=100)(A_int)
        return cheb_cg_inverse_factory(rtol=1e-5, maxiter=300)(A_int)
    raise NotImplementedError(
        f"default_inverse_factory: a {type(A_int).__name__} operand takes the "
        "RCM-banded direct engine (factorize/reordered.py), which is not ported yet "
        "(ROADMAP queue 1 item 10); pass a factory, e.g. cg_inverse_factory(rtol=1e-5)"
    )


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
