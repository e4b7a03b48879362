"""Geometric multigrid V-cycle for structured-stencil DIA operators.

Counterpart of the JAX package's ``factorize/multigrid.py``. For the
constant-coefficient Dirichlet stencils a rediscretized geometric V-cycle
is spectrally equivalent to A'^-1 independently of n, so one cycle serves
as the LOBPCG preconditioner (``mg_inverse_factory``) and as the
preconditioner of a CG that converges in an n-independent number of steps
(``mg_cg_inverse_factory``, the inner solve of shift-invert on 3D stencils).

* Grid detection is structural: offsets ``{0, +-1, +-Nx[, +-Nx*Ny]}`` with
  matching ``n`` give dims ``(Ny, Nx)`` / ``(Nz, Ny, Nx)``. Stencil
  coefficients are sampled from an interior row of the operand and stay
  0-d tensors on its device (no host read).
* Level l applies the same stencil with each axis coupling scaled by
  4^-l and the zeroth-order term held fixed, matrix-free as shifted adds on
  (m, *dims) blocks (plain PyTorch: the coarse work is a geometric tail).
* The fine level smooths with the operand itself through ``spmm_t``, so on
  a CUDA tensor every fine residual runs the DIA kernel; with
  ``dtype=torch.bfloat16`` it streams bf16 (the kernel accumulates in f32).
* Smoother: damped Jacobi, symmetric pre/post; coarsest level:
  fixed-iteration CG in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dune_eigensolver_tpu_torch.factorize.cg import _cast_floating, _inv_diag_of, cg_solve_t
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t


def detect_grid_dims(offsets, n: int) -> Optional[Tuple[int, ...]]:
    """Structured-grid dims from a DIA offset pattern, or None.

    ``(…, Ny, Nx)`` with the +-1 offset the LAST (fastest) axis, matching
    the lexicographic ordering of ``problems.laplacian_dirichlet_{2d,3d}``.
    """
    offs = sorted(offsets)
    if 0 not in offs:
        return None
    pos = [o for o in offs if o > 0]
    if offs != sorted([-o for o in pos] + [0] + pos):
        return None  # not symmetric
    # dims < 3 are rejected: a (k, 2)-shaped "grid" is indistinguishable
    # from a plain banded matrix and the coarsening degenerates
    if len(pos) == 2 and pos[0] == 1:
        nx = pos[1]
        if nx >= 3 and n % nx == 0 and n // nx >= 3:
            return (n // nx, nx)
    if len(pos) == 3 and pos[0] == 1:
        nx, s2 = pos[1], pos[2]
        if nx >= 3 and s2 % nx == 0 and n % s2 == 0:
            ny, nz = s2 // nx, n // s2
            if ny >= 3 and nz >= 3:
                return (nz, ny, nx)
    return None


def _coarse_levels(dims: Tuple[int, ...], min_coarse: int) -> Tuple[Tuple[int, ...], ...]:
    levels = [tuple(dims)]
    while min(levels[-1]) > min_coarse:
        levels.append(tuple(d // 2 for d in levels[-1]))
    return tuple(levels)


# --- separable grid transfer / stencil primitives on (m, *dims) blocks ---


def _shift(x: torch.Tensor, ax: int, d: int) -> torch.Tensor:
    """Zero-filled neighbour shift: y[..., i, ...] = x[..., i+d, ...]."""
    size = x.shape[ax]
    zero = torch.zeros_like(x.narrow(ax, 0, 1))
    if d > 0:
        return torch.cat([x.narrow(ax, 1, size - 1), zero], dim=ax)
    return torch.cat([zero, x.narrow(ax, 0, size - 1)], dim=ax)


def _stencil_apply(x: torch.Tensor, c0, a_axes) -> torch.Tensor:
    """(c0 I + sum_ax a_ax * (shift+ + shift-)) x; a_axes ordered fastest
    axis first (the +-1 coupling), i.e. a_axes[k] acts on axis -1-k."""
    y = c0 * x
    for k, a in enumerate(a_axes):
        ax = x.ndim - 1 - k
        y = y + a * (_shift(x, ax, 1) + _shift(x, ax, -1))
    return y


def _restrict1(x: torch.Tensor, ax: int) -> torch.Tensor:
    """Full weighting along ``ax``: coarse j sits at fine 2j+1 (0-based),
    r_H[j] = (f[2j] + 2 f[2j+1] + f[2j+2]) / 4 with zero past the end."""
    m = x.shape[ax] // 2
    xp = torch.cat([x, torch.zeros_like(x.narrow(ax, 0, 1))], dim=ax)

    def strided(start):
        idx = [slice(None)] * x.ndim
        idx[ax] = slice(start, start + 2 * m - 1, 2)
        return xp[tuple(idx)]

    return 0.25 * strided(0) + 0.5 * strided(1) + 0.25 * strided(2)


def _prolong1(c: torch.Tensor, ax: int, d: int) -> torch.Tensor:
    """Linear interpolation along ``ax`` back to fine size ``d`` (= 2M or
    2M+1): fine[2j+1] = c[j], fine[2j] = (c[j-1] + c[j]) / 2 (Dirichlet
    zero outside)."""
    m = c.shape[ax]
    cl = _shift(c, ax, -1)  # c[j-1], c[-1] = 0
    evens = 0.5 * (cl + c)
    y = torch.stack([evens, c], dim=ax + 1)  # (..., M, 2, ...)
    shape = list(c.shape)
    shape[ax] = 2 * m
    y = y.reshape(shape)
    if d == 2 * m + 1:
        y = torch.cat([y, 0.5 * c.narrow(ax, m - 1, 1)], dim=ax)
    return y


def _restrict(x: torch.Tensor) -> torch.Tensor:
    for ax in range(1, x.ndim):
        x = _restrict1(x, ax)
    return x


def _prolong(c: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    for k in range(len(dims)):
        c = _prolong1(c, k + 1, dims[k])
    return c


def _coarse_cg(apply_a, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration CG (no data-dependent control flow, no host read):
    the coarsest-grid solve, with per-row step lengths and dots over the
    grid axes."""
    axes = tuple(range(1, b.ndim))
    bshape = (-1,) + (1,) * (b.ndim - 1)

    def dot(u, v):
        return torch.sum(u * v, dim=axes)

    x = torch.zeros_like(b)
    r, p, rz = b, b, dot(b, b)
    for _ in range(iters):
        ap = apply_a(p)
        pap = dot(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        x = x + alpha.reshape(bshape) * p
        r = r - alpha.reshape(bshape) * ap
        rz_n = dot(r, r)
        beta = torch.where(rz > 0, rz_n / torch.where(rz > 0, rz, 1.0), 0.0)
        p = r + beta.reshape(bshape) * p
        rz = rz_n
    return x


def _geom_of(A_int):
    """(dims, n) of a DIA operand, or ValueError."""
    n = A_int.shape[0]
    offsets = getattr(A_int, "offsets", None)
    if offsets is None:
        raise ValueError(f"multigrid: {type(A_int).__name__} is not a DIA operand")
    dims = detect_grid_dims(offsets, n)
    if dims is None:
        raise ValueError(
            f"multigrid: offsets {A_int.offsets} are not a structured "
            "2D/3D stencil pattern"
        )
    return dims, n


def _grid_strides(dims) -> Tuple[int, ...]:
    """Lexicographic strides of ``dims``, fastest axis first (1, Nx, Nx*Ny)."""
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    return tuple(strides)


def _sampled_coeffs(A_int, dims):
    """Interior stencil coefficients (c0, a_axes, sigma) as 0-d f32 tensors
    on the operand's device.

    a_axes is ordered fastest axis first (offset +1, +Nx, +Nx*Ny); sigma is
    the zeroth-order remainder, held fixed across levels while the
    couplings scale by 1/4."""
    strides = _grid_strides(dims)
    mid = sum((d // 2) * st for d, st in zip(reversed(dims), strides))
    data = A_int.data
    c0 = data[A_int.offsets.index(0), mid].to(torch.float32)
    a_axes = tuple(
        data[A_int.offsets.index(st), mid].to(torch.float32) for st in strides
    )
    sigma = c0 + 2.0 * sum(a_axes)
    return c0, a_axes, sigma


def _vcycle_coarse(levels, level, b, a_fine, sigma, nu1, nu2, omega,
                   coarse_iters):
    """Coarse-level V-cycle recursion on (m, *dims) blocks: matrix-free
    rediscretized stencils, damped-Jacobi smoothing, fixed-iteration f32
    CG at the coarsest level."""
    dims_l = levels[level]
    a_l = tuple(a * (0.25**level) for a in a_fine)
    c0_l = sigma - 2.0 * sum(a_l)
    if level == len(levels) - 1:
        a32 = tuple(a.to(torch.float32) for a in a_l)
        x = _coarse_cg(
            lambda v: _stencil_apply(v, c0_l.to(torch.float32), a32),
            b.to(torch.float32),
            coarse_iters,
        )
        return x.to(b.dtype)
    dt = b.dtype
    inv_c = (omega / c0_l).to(dt)
    a_dt = tuple(a.to(dt) for a in a_l)
    c0_dt = c0_l.to(dt)
    apply_l = lambda v: _stencil_apply(v, c0_dt, a_dt)  # noqa: E731
    x = inv_c * b
    for _ in range(nu1 - 1):
        x = x + inv_c * (b - apply_l(x))
    r = b - apply_l(x)
    e = _vcycle_coarse(levels, level + 1, _restrict(r), a_fine, sigma,
                       nu1, nu2, omega, coarse_iters)
    x = x + _prolong(e, dims_l)
    for _ in range(nu2):
        x = x + inv_c * (b - apply_l(x))
    return x


def _mg_solve_fn(geom, levels, cycles, nu1, nu2, omega, coarse_iters, dtype):
    """The V-cycle apply ``fn(aux, Xt)`` for one geometry and setting."""
    dims, n = geom

    def solve(aux, Xt):
        A_, inv_d = aux
        out_dt = Xt.dtype
        _, a_fine, sigma = _sampled_coeffs(A_, dims)
        if dtype is not None:
            A_, inv_d, Xt = (
                _cast_floating(A_, dtype),
                inv_d.to(dtype),
                Xt.to(dtype),
            )
        m = Xt.shape[0]
        omega_t = torch.tensor(omega, dtype=Xt.dtype, device=Xt.device)
        wdiag = (omega_t * inv_d)[None, :]
        b = Xt
        x = wdiag * b  # first Jacobi sweep from x = 0
        for cyc in range(cycles):
            for _ in range(nu1 - 1 if cyc == 0 else nu1):
                x = x + wdiag * (b - spmm_t(A_, x))
            if len(levels) > 1:
                r = b - spmm_t(A_, x)
                e = _vcycle_coarse(
                    levels, 1, _restrict(r.reshape((m,) + dims)), a_fine,
                    sigma, nu1, nu2, omega, coarse_iters,
                )
                x = x + _prolong(e, dims).reshape(m, n)
            for _ in range(nu2):
                x = x + wdiag * (b - spmm_t(A_, x))
        return x.to(out_dt)

    solve.layout_t = True
    return solve


def mg_inverse_factory(
    cycles: int = 1,
    nu1: int = 2,
    nu2: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 48,
    min_coarse: int = 6,
    dtype=None,
):
    """``cycles`` V(nu1,nu2)-cycles as an approximate inverse: the LOBPCG
    preconditioner for structured 2D/3D stencil operands. ``dtype`` (e.g.
    ``torch.bfloat16``) is the storage type of the fine-level smoothing.
    ``inverse(A)`` raises ValueError when the offsets are not a structured
    stencil pattern."""

    def inverse(A_int):
        geom = _geom_of(A_int)
        levels = _coarse_levels(geom[0], min_coarse)
        fn = _mg_solve_fn(geom, levels, cycles, nu1, nu2, omega, coarse_iters, dtype)
        return ((A_int, _inv_diag_of(A_int)), fn)

    return inverse


def _mg_cg_solve_fn(geom, levels, rtol, maxiter, cycles, nu1, nu2, omega, coarse_iters, dtype):
    """V-cycle-preconditioned CG ``fn(aux, Xt)`` for one geometry and
    setting; with ``dtype`` the whole solve (operand, iterate, V-cycle) runs
    in it."""
    mg_fn = _mg_solve_fn(geom, levels, cycles, nu1, nu2, omega, coarse_iters, dtype=None)

    def solve(aux, Xt):
        out_dt = Xt.dtype
        if dtype is not None:
            aux = _cast_floating(aux, dtype)
            Xt = Xt.to(dtype)
        A_, _ = aux
        Y, _ = cg_solve_t(
            lambda V: spmm_t(A_, V), Xt, rtol=rtol, maxiter=maxiter,
            precond_apply=lambda R: mg_fn(aux, R),
        )
        return Y.to(out_dt)

    solve.layout_t = True
    return solve


def mg_cg_inverse_factory(
    rtol: float = 1e-5,
    maxiter: int = 100,
    cycles: int = 1,
    nu1: int = 2,
    nu2: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 48,
    min_coarse: int = 6,
    dtype=None,
):
    """V-cycle-preconditioned CG to ``rtol``: the converging inner solve for
    shift-invert subspace iteration on wide-band (3D) stencils, with an
    O(1) condition number after preconditioning against O(sqrt(kappa)) for
    the Chebyshev-Jacobi route (factorize/chebyshev.py). ``inverse(A)``
    raises ValueError when the offsets are not a structured stencil
    pattern."""

    def inverse(A_int):
        geom = _geom_of(A_int)
        levels = _coarse_levels(geom[0], min_coarse)
        fn = _mg_cg_solve_fn(geom, levels, rtol, maxiter, cycles, nu1, nu2, omega,
                             coarse_iters, dtype)
        return ((A_int, _inv_diag_of(A_int)), fn)

    return inverse
