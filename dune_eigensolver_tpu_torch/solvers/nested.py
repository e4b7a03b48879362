"""Nested-iteration LOBPCG: seed the fine-grid solve from coarser grids.

Counterpart of the JAX package's ``solvers/nested.py``. The smallest
eigenvectors of an elliptic operator are smooth, so the same solve on a
half-resolution grid — 8x cheaper per iteration in 3D — yields a start
block that the multigrid prolongation (linear interpolation) carries to
the fine grid with O(h^2) accuracy; the fine-grid LOBPCG then only pays
the iterations that correct the interpolation error.

The coarse hierarchy is derived from the operand: grid dims are detected
from the DIA offset pattern, the interior stencil coefficients are sampled
on the device (the MG preconditioner's machinery), and each coarse
operator is assembled on the device with the same coefficients and
Dirichlet masking.

Scope: standard-problem embeddings (``b_identity=True``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dune_eigensolver_tpu_torch.factorize.multigrid import (
    _grid_strides,
    _prolong,
    _sampled_coeffs,
    detect_grid_dims,
)
from dune_eigensolver_tpu_torch.solvers.engine import memoized_setup
from dune_eigensolver_tpu_torch.solvers.lobpcg import lobpcg_generalized
from dune_eigensolver_tpu_torch.solvers.result import EigenResult
from dune_eigensolver_tpu_torch.solvers.standard import padded_width
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix
from dune_eigensolver_tpu_torch.utils.paranoid import reporting


def prolong_vectors(Y: torch.Tensor, coarse_dims: Tuple[int, ...],
                    fine_dims: Tuple[int, ...]) -> torch.Tensor:
    """Interpolate an ``(n_coarse, m)`` eigenvector block from a structured
    grid of ``coarse_dims`` to ``fine_dims`` (each fine extent = 2*coarse
    or 2*coarse+1; separable linear interpolation, Dirichlet-zero outside
    — the MG prolongation)."""
    m = Y.shape[1]
    C = Y.T.reshape((m,) + tuple(coarse_dims))
    return _prolong(C, tuple(fine_dims)).reshape(m, -1).T


def _stencil_dia_data(dims: Tuple[int, ...], c0: torch.Tensor, a_axes,
                      dtype) -> torch.Tensor:
    """DIA data, built on c0's device, for a separable +-1-per-axis stencil
    on ``dims`` with interior coefficients (c0, a_axes) and Dirichlet
    masking (couplings across the lexicographic wrap are zeroed)."""
    n = math.prod(dims)
    dev = c0.device
    i = torch.arange(n, dtype=torch.int64, device=dev)
    zero = torch.tensor(0.0, dtype=dtype, device=dev)
    lo, hi = [], []
    for k, (st, a) in enumerate(zip(_grid_strides(dims), a_axes)):
        d = dims[len(dims) - 1 - k]
        ax = (i // st) % d
        a_ = a.to(dtype)
        lo.append(torch.where(ax != 0, a_, zero))
        hi.append(torch.where(ax != d - 1, a_, zero))
    center = torch.full((n,), 1.0, dtype=dtype, device=dev) * c0.to(dtype)
    # offsets ascending: (-s_max ... -1, 0, +1 ... +s_max)
    rows = list(reversed(lo)) + [center] + hi
    return torch.stack(rows)


def _coarse_operator(A: DIAMatrix, dims: Tuple[int, ...]) -> DIAMatrix:
    """Same-coefficient rediscretization of the DIA operand ``A`` on the
    coarser structured grid ``dims`` (coefficients sampled at an interior
    point, exactly like the MG preconditioner's coarse levels)."""
    c0, a_axes, _sigma = _sampled_coeffs(A, detect_grid_dims(A.offsets, A.shape[0]))
    data = _stencil_dia_data(tuple(dims), c0, a_axes, A.dtype)
    strides = _grid_strides(dims)
    offsets = tuple(-st for st in reversed(strides)) + (0,) + strides
    n = math.prod(dims)
    return DIAMatrix(data=data, offsets=offsets, shape=(n, n))


def _identity_b(n: int, dtype, device) -> DIAMatrix:
    return DIAMatrix(
        data=torch.ones((1, n), dtype=dtype, device=device), offsets=(0,),
        shape=(n, n),
    )


@reporting
def lobpcg_nested(
    A: DIAMatrix,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    *,
    min_coarse: int = 48,
    coarse_tol: Optional[float] = None,
    coarse_min_iter: int = 3,
    min_iter: int = 1,
    block: int = 8,
    **lobpcg_kwargs,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda x`` by nested-iteration
    LOBPCG on a structured-grid DIA operand (module docstring).

    Builds the coarse hierarchy by halving the detected grid dims while
    ``min(dims) // 2 >= min_coarse``, solves coarsest-to-finest, and seeds
    each level with the prolonged eigenvector block of the one below.
    Coarse levels solve the full padded block width at ``coarse_tol``
    (default ``max(tol/10, 1e-5)``). Requires ``b_identity=True``; all
    other keyword arguments are forwarded to every level's
    ``lobpcg_generalized`` call.
    """
    if not lobpcg_kwargs.get("b_identity", False):
        raise ValueError(
            "lobpcg_nested requires b_identity=True (standard-problem "
            "embedding); for a general B build the seed with "
            "prolong_vectors and call lobpcg_generalized(q0=...)"
        )
    if "q0" in lobpcg_kwargs:
        raise ValueError(
            "lobpcg_nested derives q0 from the coarse hierarchy; to use "
            "your own seed call lobpcg_generalized(q0=...) directly"
        )
    n = A.shape[0]
    dims = detect_grid_dims(A.offsets, n)
    if dims is None:
        raise ValueError(
            f"lobpcg_nested: offsets {A.offsets} are not a structured "
            "2D/3D stencil pattern; pass q0 to lobpcg_generalized instead"
        )
    levels = [tuple(dims)]
    while min(levels[0]) // 2 >= min_coarse:
        levels.insert(0, tuple(d // 2 for d in levels[0]))
    ctol = coarse_tol if coarse_tol is not None else max(tol / 10.0, 1e-5)
    m = padded_width(nev, block)

    def build_hierarchy():
        ops = []
        for dims_c in levels[:-1]:
            Ac = _coarse_operator(A, dims_c)
            ops.append((Ac, _identity_b(Ac.shape[0], Ac.dtype, Ac.device)))
        return tuple(ops)

    # the coarse operators are memoized on the fine operand's identity so
    # repeated solves hit the per-level preconditioner setup caches
    coarse = memoized_setup(
        (A,), ("nested_hier",) + tuple(levels[0]) + (len(levels),),
        build_hierarchy,
    )

    q0 = None
    for lvl, dims_l in enumerate(levels):
        last = lvl == len(levels) - 1
        Al, Bl = (A, B) if last else coarse[lvl]
        res = lobpcg_generalized(
            Al,
            Bl,
            nev=nev if last else m,
            tol=tol if last else ctol,
            maxiter=maxiter,
            block=block,
            min_iter=min_iter if (last and q0 is not None) else coarse_min_iter,
            q0=q0,
            **lobpcg_kwargs,
        )
        if not last:
            q0 = prolong_vectors(res.eigenvectors, dims_l, levels[lvl + 1])
    return res
