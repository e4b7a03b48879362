"""Sharded geometric-multigrid V-cycle: the LOBPCG preconditioner of the
sharded north-star recipe.

Counterpart of the JAX package's ``dist/mg.py``. The operator is split
into z-slabs, one per rank, and each cycle issues ONE collective:

* fine level, partitioned: damped-Jacobi smoothing and the residual go
  through the engine's halo SpMM (``_ShardEngine.apply``: K1 on the local
  block on a CUDA tensor, in bf16 with ``dtype=torch.bfloat16``);
* local semi-coarsening: full-weighting restriction over the axes that
  are not split (y, x in 3D) needs no neighbour, and shrinks the residual
  4x (3D) before anything crosses ranks;
* one ``all_gather`` along the slab axis gives every rank the whole
  semi-coarse residual (m, Nz, Ny/2, Nx/2);
* coarse levels, replicated: the slab-axis restriction and the single-card
  coarse V-cycle (``factorize/multigrid.py::coarse_correction``) run the same
  on every rank; the rank slices its slab back out of the prolonged
  correction (the rank replaces ``lax.axis_index``) and interpolates it up
  the local axes.

In exact arithmetic the cycle is the single-card V-cycle. At P > 1 the
restriction runs over the local axes before the slab axis, so the two
agree to roundoff (the JAX package's order at every P). At P = 1 the
gather comes first and the restriction runs in the single-card order, so
the cycle, and with it a world-size-1 solve, gives the single-card bits.

Constraints (checked, ``ValueError``, by ``sharded_mg_geometry``): a
structured 2D/3D stencil (``detect_grid_dims``) with constant
coefficients, a slab axis that the world size divides with at least 4
planes a rank, no row padding, and at least one coarse level.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from dune_eigensolver_tpu_torch.dist.sharded import all_gather_cat
from dune_eigensolver_tpu_torch.factorize.multigrid import (
    _coarse_levels,
    _prolong1,
    _restrict,
    _restrict1,
    _sampled_coeffs,
    coarse_correction,
    detect_grid_dims,
)


def sharded_mg_geometry(offsets, n_global: int, n_pad: int, P: int, min_coarse: int = 6):
    """Validate and return the grid dims for the sharded V-cycle, or raise
    ``ValueError`` (JAX :57). The replicated coarse levels are built from
    the coefficients each rank samples in its own slab, so the stencil's
    coefficients must be constant (Laplacian-like); the check is
    structural, as in the reference."""
    if n_pad != n_global:
        raise ValueError(
            f"sharded mg: n={n_global} is padded to {n_pad} for the mesh; "
            "identity pad rows break the grid structure (pick a mesh size "
            "that divides n, or use precond='cg')"
        )
    dims = detect_grid_dims(tuple(offsets), n_global)
    if dims is None:
        raise ValueError(
            f"sharded mg: offsets {tuple(offsets)} are not a structured "
            "2D/3D stencil pattern"
        )
    if dims[0] % P != 0 or dims[0] // P < 4:
        raise ValueError(
            f"sharded mg: slab axis {dims[0]} over {P} ranks gives "
            f"{dims[0] / P:g} planes a rank; need a multiple of P with >= 4 "
            "planes so every rank samples interior stencil coefficients"
        )
    if len(_coarse_levels(tuple(dims), min_coarse)) < 2:
        raise ValueError(
            f"sharded mg: grid {dims} has no coarse level above min_coarse={min_coarse}"
        )
    nloc = n_pad // P
    if (dims[0] // P) * math.prod(dims[1:]) != nloc:
        raise ValueError(
            f"sharded mg: local rows {nloc} != slab {(dims[0] // P,) + tuple(dims[1:])}"
        )
    return dims


def make_sharded_mg_prec_fn(
    eng,
    dims,
    nu1: int = 1,
    nu2: int = 1,
    omega: float = 0.8,
    coarse_iters: int = 48,
    min_coarse: int = 6,
    dtype=None,
):
    """``prec_fn(_aux, X) -> Y`` for the sharded LOBPCG core: one V(nu1,
    nu2) cycle on the engine's operand 0 (the shifted operator), on the
    rank's local (m, nloc) rows (JAX :114). ``dims`` from
    ``sharded_mg_geometry``."""
    mesh = eng.mesh
    P = mesh.size
    lnz = dims[0] // P
    dims_loc = (lnz,) + tuple(dims[1:])
    nloc = eng.nloc
    assert lnz * math.prod(dims[1:]) == nloc, (dims_loc, nloc)
    levels = _coarse_levels(tuple(dims), min_coarse)
    assert len(levels) >= 2, (dims, min_coarse)
    local_axes = tuple(range(2, 1 + len(dims)))  # the axes that are not split
    # every rank samples ITS OWN slab's interior row; constant coefficients
    # make the values, and so the replicated coarse levels, the same on all
    a_loc = SimpleNamespace(data=eng.datas[0], offsets=eng.offsets_list[0])
    apply_a = eng.apply(0, dtype=dtype)
    inv_d = eng.inv_diag(0)
    inv_diag = inv_d if dtype is None else inv_d.to(dtype)

    def prec_fn(_aux, X):
        out_dt = X.dtype
        _, a_fine, sigma = _sampled_coeffs(a_loc, dims_loc)
        b = X if dtype is None else X.to(dtype)
        omega_t = torch.tensor(omega, dtype=b.dtype, device=b.device)
        wdiag = (omega_t * inv_diag)[None, :]
        m = b.shape[0]
        # fine level: partitioned pre-smoothing (halo SpMM)
        x = wdiag * b
        for _ in range(nu1 - 1):
            x = x + wdiag * (b - apply_a(x))
        r = b - apply_a(x)
        r_grid = r.reshape((m,) + dims_loc)
        if P == 1:
            # the one collective, then the single-card restriction order
            r1 = _restrict(all_gather_cat(r_grid, mesh, dim=1))
        else:
            # local semi-coarsening over the axes that are not split
            for ax in local_axes:
                r_grid = _restrict1(r_grid, ax)
            # the one collective: every rank gets the whole semi-coarse residual
            r_full = all_gather_cat(r_grid, mesh, dim=1)
            # replicated: slab-axis restriction
            r1 = _restrict1(r_full, 1)
        e1 = coarse_correction(levels, r1, a_fine, sigma, nu1, nu2, omega, coarse_iters)
        ez = _prolong1(e1, 1, dims[0])
        e_loc = ez.narrow(1, mesh.rank * lnz, lnz)
        # local prolongation up the axes that are not split
        for k, ax in enumerate(local_axes):
            e_loc = _prolong1(e_loc, ax, dims[1 + k])
        x = x + e_loc.reshape(m, nloc)
        # fine level: partitioned post-smoothing
        for _ in range(nu2):
            x = x + wdiag * (b - apply_a(x))
        return x.to(out_dt)

    return prec_fn

