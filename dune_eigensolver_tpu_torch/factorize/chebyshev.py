"""Chebyshev polynomial inverse application (preconditioner engine).

Counterpart of the JAX package's ``factorize/chebyshev.py``: a fixed-degree
Chebyshev approximation of ``A^-1`` on a spectral interval. Per degree it
costs one SpMM plus three axpys and, unlike CG, no inner dot products and
no data-dependent control flow, so an application reads nothing back to the
host. It runs on the transposed (m, n) multivector, so every SpMM inside
the polynomial runs the operand's kernel through ``spmm_t``.

Spectral bounds come from one blocked power iteration on the Jacobi-scaled
operator ``D^-1 A``, run once at factory time on the device. The smoothing
interval is ``[lmax/cond_target, lmax]``: the Chebyshev error on it decays
like ((sqrt(k)-1)/(sqrt(k)+1))^deg with k = cond_target.

The operator ``p(D^-1 A) D^-1`` is SPD whenever p > 0 on the spectrum, as
LOBPCG and CG require of a preconditioner.

Factories return ``(aux, fn)`` pairs with ``fn.layout_t = True``, as
``cg_inverse_factory`` does. Not ported yet: the ``apply_a``/
``gram_reduce``/``fold`` hooks of the distributed layer.
"""

from __future__ import annotations

from typing import Optional

import torch

from dune_eigensolver_tpu_torch.factorize.cg import _cast_floating, _inv_diag_of, cg_solve_t
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

POWER_SEED = 42  # the reference's PRNGKey(42) for the power iteration's start


def _power_lmax_t(apply_a, inv_diag, n: int, dtype, iters: int, generator: torch.Generator):
    """Largest eigenvalue of ``D^-1 A`` by blocked power iteration on an
    8-row block, as a 0-d tensor on the device. The N(0,1) start comes from
    ``generator`` (on the operand's device): the top mode of diffusion-type
    operators is highly oscillatory, and a smooth deterministic start is
    nearly orthogonal to it."""
    v = torch.randn((8, n), generator=generator, dtype=dtype, device=generator.device)

    def mat(u):
        w = apply_a(u)
        return w if inv_diag is None else w * inv_diag[None, :]

    for _ in range(iters):
        w = mat(v)
        nrm = torch.sqrt(torch.sum(w * w, dim=1))
        v = w / torch.clamp(nrm, min=1e-30)[:, None]
    w = mat(v)
    num = torch.sum(v * w, dim=1)
    den = torch.sum(v * v, dim=1)
    return torch.max(num / torch.clamp(den, min=1e-30))


def chebyshev_apply_t(apply_a, R: torch.Tensor, lmin, lmax, degree: int, inv_diag=None):
    """W ~ A^-1 R via degree-``degree`` Chebyshev iteration on [lmin, lmax]
    (eigen-bounds of ``D^-1 A`` when ``inv_diag`` is given, of A otherwise).
    Transposed layout R (m, n); no dot products; ``lmin``/``lmax`` are
    floats or 0-d tensors (nothing is read to the host).

    ``degree`` is rounded up to ODD. The applied polynomial
    p(x) = (1 - r(x))/x with residual r(x) = T_d(sigma(x))/T_d(sigma1) is
    positive on (0, lmax] for any d, but for x > lmax the sign of T_d flips
    with the parity of d: even d makes p negative above lmax, so an
    underestimated lmax would silently turn the preconditioner indefinite.
    Odd d keeps p > 0 on all of (0, inf).
    """
    degree = int(degree) | 1  # round up to odd (see docstring)
    prec = (lambda V: V) if inv_diag is None else (lambda V: V * inv_diag[None, :])
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1

    # the rho recurrence stays in the scalars' own precision; cast only at
    # the array multiply so a bf16 iterate is not promoted back to f32
    def _c(s):
        if isinstance(s, torch.Tensor):
            return s.to(R.dtype)
        return torch.tensor(s, dtype=R.dtype, device=R.device)

    x = torch.zeros_like(R)
    r = R
    d = prec(r) * _c(1.0 / theta)
    for _ in range(degree):
        x = x + d
        r = r - apply_a(d)
        rho_next = 1.0 / (2.0 * sigma1 - rho)
        d = _c(rho_next * rho) * d + _c(2.0 * rho_next / delta) * prec(r)
        rho = rho_next
    return x


def chebyshev_apply(apply_a, R: torch.Tensor, lmin, lmax, degree: int, inv_diag=None):
    """Column-layout wrapper over ``chebyshev_apply_t`` (R (n, m), inv_diag
    (n,) reciprocal diagonal)."""
    apply_a_t = lambda Xt: apply_a(Xt.T).T  # noqa: E731
    return chebyshev_apply_t(apply_a_t, R.T, lmin, lmax, degree, inv_diag).T


def _check(what: str, degree: int, cond_target: float):
    if not cond_target > 1.0:
        raise ValueError(f"{what}: cond_target must be > 1, got {cond_target}")
    if int(degree) < 1:
        raise ValueError(f"{what}: degree must be >= 1, got {degree}")


def _bounds(A_int, inv_diag, power_iters, lmax_scale, cond_target, generator):
    """(lmin, lmax) of ``D^-1 A`` as 0-d tensors on the operand's device."""
    if generator is None:
        generator = torch.Generator(device=A_int.device).manual_seed(POWER_SEED)
    with torch.no_grad():
        lmax = _power_lmax_t(lambda V: spmm_t(A_int, V), inv_diag, A_int.shape[0],
                             A_int.dtype, int(power_iters), generator) * lmax_scale
    return lmax / cond_target, lmax


def chebyshev_inverse_factory(
    degree: int = 17,
    cond_target: float = 30.0,
    lmax_scale: float = 1.1,
    power_iters: int = 40,
    jacobi: bool = True,
    dtype=None,
    generator: Optional[torch.Generator] = None,
):
    """Factory of factories (same contract as ``cg_inverse_factory``):
    ``inverse(A_int)`` yields the Chebyshev approximate inverse of A_int
    (transposed layout, marked ``layout_t``).

    degree: polynomial degree (SpMMs per application). Values <= 0 are
        rejected; even values are rounded up to odd (SPD-safety).
    cond_target: lmin = lmax / cond_target, how deep into the low spectrum
        the polynomial stays accurate. Must be > 1.
    jacobi: scale by D^-1 (recommended; bounds then live on D^-1 A).
    dtype: stream the polynomial recurrence in this dtype (casting in/out
        at the boundary); preconditioner-grade, same caveats as
        ``cg_inverse_factory(dtype=...)``.
    generator: the ``torch.Generator`` (on the operand's device) the power
        iteration's start block is drawn from; default a fresh one seeded
        with ``POWER_SEED``.
    """
    _check("chebyshev", degree, cond_target)

    def inverse(A_int):
        inv_diag = _inv_diag_of(A_int) if jacobi else None
        lmin, lmax = _bounds(A_int, inv_diag, power_iters, lmax_scale, cond_target, generator)
        return (A_int, inv_diag, lmin, lmax), _cheb_solve_fn(int(degree), dtype)

    return inverse


def cheb_cg_inverse_factory(
    degree: int = 7,
    cond_target: float = 30.0,
    rtol: float = 1e-5,
    maxiter: int = 200,
    lmax_scale: float = 1.1,
    power_iters: int = 40,
    generator: Optional[torch.Generator] = None,
):
    """Chebyshev-preconditioned CG inverse, the default for wide-band
    operands that are no structured stencil.

    Pure Jacobi-CG needs O(sqrt(kappa)) dot-product-bearing iterations; with
    a fixed degree-d Chebyshev polynomial of ``D^-1 A`` as the CG
    preconditioner the outer iteration count drops by ~d while each outer
    step stays dot-free inside the polynomial. The polynomial is FIXED
    (constant bounds, odd degree -> SPD), as CG requires of its
    preconditioner.
    """
    _check("cheb_cg", degree, cond_target)

    def inverse(A_int):
        inv_diag = _inv_diag_of(A_int)
        lmin, lmax = _bounds(A_int, inv_diag, power_iters, lmax_scale, cond_target, generator)
        return (A_int, inv_diag, lmin, lmax), _cheb_cg_solve_fn(int(degree), float(rtol),
                                                               int(maxiter))

    return inverse


def _cheb_cg_solve_fn(degree, rtol, maxiter):
    def solve_pair(aux, Xt):
        A_, inv_diag, lmin, lmax = aux

        def apply_a(V):
            return spmm_t(A_, V)

        Y, _ = cg_solve_t(
            apply_a, Xt, rtol=rtol, maxiter=maxiter,
            precond_apply=lambda R: chebyshev_apply_t(apply_a, R, lmin, lmax, degree, inv_diag),
        )
        return Y

    solve_pair.layout_t = True
    return solve_pair


def _cheb_solve_fn(degree, dtype=None):
    def solve_pair(aux, Xt):
        A_, inv_diag, lmin, lmax = aux
        out_dt = Xt.dtype
        if dtype is not None:
            A_ = _cast_floating(A_, dtype)
            inv_diag = None if inv_diag is None else inv_diag.to(dtype)
            Xt = Xt.to(dtype)
        Y = chebyshev_apply_t(lambda V: spmm_t(A_, V), Xt, lmin, lmax, degree, inv_diag)
        return Y.to(out_dt)

    solve_pair.layout_t = True
    return solve_pair
