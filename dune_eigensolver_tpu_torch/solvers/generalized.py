"""Generalized eigenproblem solver: smallest eigenpairs of ``A x = lambda B x``
by shift-invert inverse iteration with B-orthonormalization.

Counterpart of the JAX package's ``solvers/generalized.py``, whose
semantics are the reference's flagship ``GeneralizedInverse`` (GenEO
coarse-space setup):

  A' = A + shift*B + reg*I  (pattern(B) must be within pattern(A))
  set up A'^-1 once; B-orthonormalize Q
  loop:  Q2 = B Q1;  Q1 = A'^-1 Q2;  B-orthonormalize Q1
         rayleigh: ra_i = (Q1^T A' Q1)_ii - shift
         relerror = max_i |ra1_i - ra2_i| / max_i ra1_i
         stop when iter > min_iter and relerror < tol

The iteration state is the transposed multivector (m, n). The reference's
``lax.while_loop`` is a Python loop that reads the stopping quantity to the
host once per iteration; the stopping rule is the reference's, change-based
(not a residual test).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dune_eigensolver_tpu_torch.ops.ortho import (
    b_orthonormalize_blocked_t,
    dot_products_diagonal_t,
)
from dune_eigensolver_tpu_torch.solvers.engine import (
    adapt_inverse,
    from_internal_vectors,
    make_engine,
    memoized_setup,
    to_internal,
)
from dune_eigensolver_tpu_torch.solvers.result import EigenResult, sort_result_t
from dune_eigensolver_tpu_torch.solvers.standard import (
    normalize_inverse,
    padded_width,
    random_multivector_t,
    shifted_operand,
)
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t
from dune_eigensolver_tpu_torch.utils.paranoid import reporting


def _gen_core(apply_a, apply_b, inv_aux, inv_fn, Q0, nev, tol, maxiter, shift,
              block, min_iter, ortho_iterations, rayleigh_ritz, gram_reduce=None):
    """The reference's loop (module docstring). ``gram_reduce`` (JAX
    ``_gen_core``'s hook): the all-reduce of every Gram and dot when Q0 is
    the rank's local rows (``dist/sharded.py``); ``None`` adds no
    operation."""
    shift_ = torch.tensor(shift, dtype=Q0.dtype, device=Q0.device)
    reduce_ = gram_reduce or (lambda g: g)

    def b_ortho(Q):
        return b_orthonormalize_blocked_t(
            apply_b, Q, block=block, iterations=ortho_iterations, gram_reduce=gram_reduce
        )

    def rayleigh(Q):
        """Ritz values (and rotated Q). With rayleigh_ritz the m x m
        projected problem Q^T A Q (B-orthonormal Q) is diagonalized and Q is
        rotated into the Ritz basis; without it, the reference's
        per-column quotients."""
        AQ = apply_a(Q)
        if not rayleigh_ritz:
            return reduce_(dot_products_diagonal_t(AQ, Q)) - shift_, Q
        G = reduce_(AQ @ Q.T)
        G = 0.5 * (G + G.T)
        lam, V = torch.linalg.eigh(G)
        return lam - shift_, V.T @ Q

    Q, norm = b_ortho(Q0)
    ra2, Q = rayleigh(Q)
    it = 0
    relerror = torch.tensor(float("inf"), dtype=Q0.dtype, device=Q0.device)
    while it < maxiter and (it <= min_iter or bool(relerror >= tol)):
        Q1 = inv_fn(inv_aux, apply_b(Q))
        Q1, norm = b_ortho(Q1)
        ra1, Q = rayleigh(Q1)
        relerror = torch.max(torch.abs(ra1 - ra2)) / torch.max(ra1)
        ra2 = ra1
        it += 1
    evals, evecs_t = sort_result_t(ra2, Q, nev, descending=False)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t),
        iterations=torch.tensor(it, dtype=torch.int32),
        converged=relerror < tol,
        criterion=relerror,
        ortho_monitor=norm,
    )


@reporting
def generalized_inverse(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 10,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    inverse: Optional[Callable] = None,
    apply_a: Optional[Callable] = None,
    apply_b: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[torch.Tensor] = None,
    eval_shift: Optional[float] = None,
    dtype=None,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda B x``.

    ``inverse``: factory mapping the shifted operator A' = A + shift*B +
    reg*I (its internal form, see ``make_engine``) to a multi-RHS solve: a
    plain callable ``X -> A'^-1 X`` or a pair ``(aux, fn)`` with
    ``fn(aux, X)``; column-layout solves are bridged to the internal
    transposed layout. Pass ``cg_inverse_factory(...)`` for the matrix-free
    path. Default: ``factorize.default_inverse_factory``, which picks the
    engine by the operand as the reference does (the block-banded direct
    engine for DIA bands up to 2048, V-cycle-CG for wider 3D stencils,
    Chebyshev-CG for other wide DIA, RCM-banded for ELL/BSR).

    ``apply_a``/``apply_b``/``gram_reduce`` (the JAX package's hooks, on
    the transposed (m, n_local) layout): the caller's A' and B products
    and the reduction of every Gram and dot (a psum over row shards). With
    both ``apply_a`` and ``apply_b`` the solve is matrix-free: no operand
    setup runs, the setup memo is untouched, and ``inverse(None)`` gives
    the solve, which then runs on the transposed layout as it is (e.g.
    ``cg_inverse_factory(apply_a=...)``). Any other subset of hooks
    replaces only the products it names; the rest run through the
    operand's ``spmm_t``.

    ``q0``: the start block, m = nev rounded up to ``block``; default a
    ``torch.Generator`` draw from ``seed`` on A's device, in ``dtype``
    (default A's). Its layout is the column layout (n, m) without hooks,
    and the transposed internal layout (m, n_local) when ``gram_reduce`` is
    given or the solve is matrix-free, as in the JAX package.

    ``eval_shift``: the shift the Rayleigh quotients are un-shifted by
    (default ``shift``), for a caller that folded the shift into A (or
    ``apply_a``) itself and passes ``shift=0``. ``force_padded`` has no
    counterpart (no guarded layout here).
    """
    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    matrix_free = apply_a is not None and apply_b is not None
    if matrix_free:
        inv_aux, inv_fn = normalize_inverse(inverse(None))
    else:
        if inverse is None:
            from dune_eigensolver_tpu_torch.factorize import default_inverse_factory

            inverse = default_inverse_factory

        def _build():
            A_sh = shifted_operand(A, B, shift, reg)
            A_int, B_int = make_engine(A_sh, B)
            aux, fn = adapt_inverse(*normalize_inverse(inverse(A_int)))
            return A_int, B_int, aux, fn

        # setup (shift fold, routing, inverse setup) memoized on the operand
        # identities: repeated solves on one pencil (the GenEO pattern) pay
        # it once
        A_int, B_int, inv_aux, inv_fn = memoized_setup(
            (A, inverse) if B is None else (A, B, inverse),
            ("gen", float(shift), float(reg)),
            _build,
        )
        if apply_a is None:
            apply_a = lambda X: spmm_t(A_int, X)  # noqa: E731
        if apply_b is None:
            apply_b = lambda X: spmm_t(B_int, X)  # noqa: E731
    if q0 is not None:
        Q0 = to_internal(q0 if matrix_free or gram_reduce is not None else q0.T)
    else:
        gen = torch.Generator(device=A.device).manual_seed(seed)
        Q0 = to_internal(random_multivector_t(gen, A.shape[0], m, dtype, A.device))
    with torch.no_grad():
        return _gen_core(
            apply_a, apply_b, inv_aux, inv_fn,
            Q0, nev, float(tol), int(maxiter),
            float(shift if eval_shift is None else eval_shift), int(block),
            int(min_iter), int(ortho_iterations), bool(rayleigh_ritz),
            gram_reduce=gram_reduce,
        )
