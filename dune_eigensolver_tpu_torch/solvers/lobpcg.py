"""LOBPCG: locally-optimal block preconditioned conjugate gradient.

Counterpart of the JAX package's ``solvers/lobpcg.py``. It seeks the
LARGEST eigenvalues nu of the reciprocal pencil

    B y = nu A' y,    nu = 1 / (lambda + shift),   A' = A + shift*B,

with an A'-orthonormal basis, so that B-null directions sit at nu ~ 0, the
end of the spectrum Rayleigh-Ritz never selects. The iteration state is
the transposed multivector (m, n); the search block [X; W; P] is a
(3m, n) stack of rows. Each iteration applies A' through ``spmm_t`` (the
operand's kernel on a CUDA tensor) and the preconditioner to the residuals.

The reference's ``lax.while_loop`` is a Python loop here that reads the
stopping quantity to the host once per iteration. The stopping rule is
the reference's: the largest relative change of the Ritz values, not a
residual norm.

While tracing is on (``utils/vlog.py``) the loop's phases are spans:
``lobpcg.setup`` (the memoized set-up, on a miss), ``lobpcg.spmm`` (A' and
B on X with the residual; A' on P with its normalisation; the last B on X
that B-normalises the eigenvectors),
``lobpcg.precond``, ``lobpcg.ortho`` (each blocked CholeskyQR),
``lobpcg.rr`` (Gram, ``eigh`` and the rotations of X and P) and
``lobpcg.stop`` (the host read of the stopping test alone).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from dune_eigensolver_tpu_torch.ops.ortho import b_orthonormalize_blocked_t
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
from dune_eigensolver_tpu_torch.utils.paranoid import b_identity_check, reporting
from dune_eigensolver_tpu_torch.utils.vlog import span


def _identity_apply(X):
    """apply_b for an identity mass matrix (``b_identity=True``)."""
    return X


def _identity_prec(_aux, X):
    """The preconditioner of ``precond=False``."""
    return X


def _lobpcg_core(apply_a, apply_b, prec_aux, prec_fn, Q0, nev, tol, maxiter,
                 shift, min_iter, ortho_eps, ortho_iters, ortho_block, gram_reduce=None):
    """The loop (module docstring). ``gram_reduce`` (JAX ``_lobpcg_core``'s
    hook): the all-reduce of every Gram and row dot when Q0 is the rank's
    local rows (``dist/sharded.py``, ``dist/windowed.py``); ``None`` adds
    no operation. The core reads no row count: the eigenvectors come back
    as the rows it was given."""
    reduce_ = gram_reduce or (lambda g: g)
    dtype, dev = Q0.dtype, Q0.device
    shift_ = torch.tensor(shift, dtype=dtype, device=dev)
    m = Q0.shape[0]
    tiny = torch.tensor(1e-30, dtype=dtype, device=dev)

    def a_ortho(S):
        # CholeskyQR in the A'-inner product; A' is PD so no junk handling
        # is needed (the eps floor only guards W -> 0 at convergence).
        # ortho_block='full' is one whole-basis CholeskyQR: one Gram and one
        # trisolve instead of a prefix sweep, but its Gram sees cond(S)^2.
        # Otherwise the block is clamped: the iteration-0 ortho sees the
        # (m, n) start block, the loop the (3m, n) search basis
        blk = S.shape[0] if ortho_block == "full" else min(ortho_block, S.shape[0])
        with span("lobpcg.ortho"):
            S, _ = b_orthonormalize_blocked_t(
                apply_a, S, block=blk, iterations=ortho_iters, eps=ortho_eps,
                gram_reduce=gram_reduce,
            )
        return S

    def ritz(S, k):
        """Rayleigh-Ritz for the largest-k of ``B y = nu A' y`` on an
        A'-orthonormal basis S: returns (nu, V) with nu descending."""
        G = reduce_(apply_b(S) @ S.T)
        G = 0.5 * (G + G.T)
        nu, V = torch.linalg.eigh(G)  # ascending
        return nu.flip(0)[:k], V.flip(1)[:, :k]

    def lam_of(nu):
        return 1.0 / torch.maximum(nu, tiny) - shift_

    def unconverged(relerror):
        going = relerror >= tol
        with span("lobpcg.stop"):
            return bool(going)

    # --- iteration 0: Rayleigh-Ritz on the start block alone ---
    X = a_ortho(Q0)
    with span("lobpcg.rr"):
        nu, V = ritz(X, m)
        X = V.T @ X
    lam = lam_of(nu)
    P = None  # no search direction before the first update
    it = 0
    relerror = torch.tensor(float("inf"), dtype=dtype, device=dev)
    while it < maxiter and (it <= min_iter or unconverged(relerror)):
        with span("lobpcg.spmm"):
            AX = apply_a(X)
            BX = apply_b(X)
            nu = reduce_(torch.sum(X * BX, dim=1))  # X is A'-orthonormal
            R = BX - AX * nu[:, None]
            del AX, BX
        with span("lobpcg.precond"):
            W = prec_fn(prec_aux, R)
        del R
        # Row-normalize the preconditioned residuals: per-pair convergence
        # differs by orders of magnitude, and the blocked CholeskyQR's Gram
        # sees the square of that range. Scaling rows leaves the span as is.
        wn = reduce_(torch.sum(W * W, dim=1))
        W = W / torch.sqrt(torch.maximum(wn, tiny))[:, None]
        # P is absent on the first pass; the filler is projected to noise
        # by the orthonormalization (eps floor) and never selected by RR
        S = torch.cat([X, W, W * 0.5 if P is None else P], dim=0)  # (3m, n)
        del W, P
        S = a_ortho(S)
        with span("lobpcg.rr"):
            nu_all, Vx = ritz(S, m)
            X = Vx.T @ S
            # LOBPCG direction: the Ritz rotation restricted to the [W, P] block
            Vp = Vx.clone()
            Vp[:m] = 0.0
            P = Vp.T @ S
        del S
        # A'-normalize P rows (guard against zero rows)
        with span("lobpcg.spmm"):
            pn = reduce_(torch.sum(P * apply_a(P), dim=1))
            P = P / torch.sqrt(torch.maximum(pn, tiny))[:, None]
        lam_n = lam_of(nu_all)
        relerror = torch.max(torch.abs(lam_n - lam)) / torch.maximum(
            torch.max(torch.abs(lam_n)), tiny
        )
        lam = lam_n
        it += 1
    # X rows are A'-orthonormal; rescale to B-normalized eigenvectors
    with span("lobpcg.spmm"):
        bmass = reduce_(torch.sum(X * apply_b(X), dim=1))
        X = X / torch.sqrt(torch.maximum(bmass, tiny))[:, None]
    evals, evecs_t = sort_result_t(lam, X, nev, descending=False)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t),
        iterations=torch.tensor(it, dtype=torch.int32),
        converged=relerror < tol,
        criterion=relerror,
        ortho_monitor=torch.zeros((), dtype=dtype, device=dev),
    )


@reporting
def lobpcg_generalized(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 3,
    ortho_eps: float = 1e-9,
    ortho_iterations: int = 2,
    ortho_block: Optional[Union[int, str]] = None,
    b_identity: bool = False,
    precond=None,
    apply_a: Optional[Callable] = None,
    apply_b: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[torch.Tensor] = None,
    eval_shift: Optional[float] = None,
    dtype=None,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda B x`` by preconditioned
    LOBPCG on the reciprocal pencil (module docstring). Requires
    A' = A + shift*B + reg*I positive definite.

    ``ortho_iterations``: CholeskyQR passes per basis orthonormalization.
    ``ortho_block``: row-block size of the orthonormalization sweep
    (default ``block``); ``'full'`` is one whole-basis CholeskyQR (one Gram,
    one Cholesky), valid where the preconditioner keeps the basis well
    conditioned: its Gram sees cond(S)^2.
    ``b_identity=True`` asserts B is the identity, so ``B @ X`` is skipped;
    the assertion is the caller's, checked only in paranoid mode
    (``utils/paranoid.py::b_identity_check``).
    ``precond``: factory mapping A' to an approximate inverse apply (a
    callable or an ``(aux, fn)`` pair), or ``False`` for none. Default:
    ``factorize.default_inverse_factory``, the engine the shift-invert
    solvers use (a direct solve for 2D stencils, narrow 3D ones, ELL and
    BSR: an exact inverse as the preconditioner, as in the reference).

    ``apply_a``/``apply_b``/``gram_reduce`` (the JAX package's hooks, on
    the transposed (m, n_local) layout): the caller's A' and B products
    and the reduction of every Gram and row dot (a psum over row shards).
    With both ``apply_a`` and ``apply_b`` the solve is matrix-free: no
    operand setup runs and the setup memo is untouched, ``precond(None)``
    gives the preconditioner, which then runs on the transposed layout as
    it is, and ``precond=False`` is the identity. Any other subset of
    hooks replaces only the products it names; the rest run through the
    operand's ``spmm_t``. A caller that folded the shift into ``apply_a``
    passes ``shift=0`` and the shift as ``eval_shift``.

    ``q0``: the start block; default a ``torch.Generator`` draw from
    ``seed`` on A's device, in ``dtype`` (default A's). Its layout is the
    column layout (n, m) without hooks, and the transposed internal layout
    (m, n_local) when ``gram_reduce`` is given or the solve is matrix-free,
    as in the JAX package.
    ``eval_shift``: the shift the eigenvalues are un-shifted by (default
    ``shift``), for a caller that folded the shift into A itself.
    """
    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    matrix_free = apply_a is not None and apply_b is not None
    if matrix_free:
        if precond is False:
            prec_aux, prec_fn = None, _identity_prec
        else:
            prec_aux, prec_fn = normalize_inverse(precond(None))
    else:
        if precond is None:
            from dune_eigensolver_tpu_torch.factorize import default_inverse_factory

            precond = default_inverse_factory

        def _build():
            with span("lobpcg.setup"):
                A_sh = shifted_operand(A, B, shift, reg)
                A_int, B_int = make_engine(A_sh, B)
                if precond is False:
                    aux, fn = None, _identity_prec
                else:
                    aux, fn = adapt_inverse(*normalize_inverse(precond(A_int)))
            return A_int, B_int, aux, fn

        # setup memoized on operand identities: repeated solves on one pencil
        # pay the shift fold and preconditioner setup once
        objs = (A,) if precond is False else (A, precond)
        A_int, B_int, prec_aux, prec_fn = memoized_setup(
            objs if B is None else objs + (B,),
            ("lobpcg", float(shift), float(reg), 3 * m),
            _build,
        )
        if apply_a is None:
            apply_a = lambda X: spmm_t(A_int, X)  # noqa: E731
        if b_identity and apply_b is None:
            b_identity_check(B)  # paranoid mode only; a no-op otherwise
            apply_b = _identity_apply
        elif apply_b is None:
            apply_b = lambda X: spmm_t(B_int, X)  # noqa: E731
    if q0 is not None:
        Q0 = to_internal(q0 if matrix_free or gram_reduce is not None else q0.T)
    else:
        gen = torch.Generator(device=A.device).manual_seed(seed)
        Q0 = to_internal(random_multivector_t(gen, A.shape[0], m, dtype, A.device))
    with torch.no_grad():
        return _lobpcg_core(
            apply_a, apply_b, prec_aux, prec_fn, Q0,
            nev, float(tol), int(maxiter),
            float(shift if eval_shift is None else eval_shift), int(min_iter),
            float(ortho_eps), int(ortho_iterations),
            "full" if ortho_block == "full" else int(ortho_block or block),
            gram_reduce=gram_reduce,
        )
