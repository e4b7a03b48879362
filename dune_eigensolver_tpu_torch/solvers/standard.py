"""Standard eigenproblem solvers: blocked orthogonal (power) iteration for
the largest eigenpairs, and shift-invert inverse iteration for the smallest;
and the helpers the other solvers share.

Counterpart of the JAX package's ``solvers/standard.py`` (reference
semantics: ``StandardLargest``/``StandardInverse``). The iteration state is
the transposed multivector (m, n), so every A @ X runs the operand's kernel
through ``spmm_t``. The reference's ``lax.while_loop`` is a Python loop here
that reads the stopping quantity to the host once per iteration, with the
reference's bounds to the letter: k in [0, maxiter), stop when k >= 2 and
the largest change of an eigenvalue is below ``tol`` (a change-based stop,
not a residual test). Eigenpairs come back sorted (descending for largest,
ascending for smallest).

``_core`` takes the distributed layer's hooks (JAX ``_largest_core``,
``standard.py:118``, and ``_sharded_inverse_core``, ``dist/sharded.py:658``):
``apply_a``/``step`` on the rank's local rows and ``gram_reduce`` on every
Gram and dot (``dist/sharded.py`` drives it); the public entry points pass
the JAX package's hook keywords through to it. ``force_padded`` has no
counterpart (no guarded layout here).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dune_eigensolver_tpu_torch.ops.ortho import (
    dot_products_diagonal_t,
    orthonormalize_blocked_t,
)
from dune_eigensolver_tpu_torch.solvers.engine import (
    adapt_inverse,
    from_internal_vectors,
    make_engine,
    memoized_setup,
    to_internal,
)
from dune_eigensolver_tpu_torch.solvers.result import EigenResult, sort_result_t
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t
from dune_eigensolver_tpu_torch.utils.paranoid import reporting


def padded_width(nev: int, block: int) -> int:
    """Round nev up to the block size."""
    return -(-nev // block) * block


def random_multivector(generator: torch.Generator, n: int, m: int, dtype,
                       device) -> torch.Tensor:
    """N(0,1) random start block, column layout (n, m), from an explicit
    ``generator`` (the reference takes a ``jax.random`` key). Column k is
    row k of ``random_multivector_t`` from the same generator state."""
    return random_multivector_t(generator, n, m, dtype, device).T


def random_multivector_t(generator: torch.Generator, n: int, m: int, dtype,
                         device) -> torch.Tensor:
    """N(0,1) random start block in the transposed (m, n) layout. The
    numbers come from ``generator`` and differ from the JAX package's
    ``jax.random`` stream for the same seed; tests that compare the two
    packages hand both the same block."""
    return torch.randn((m, n), generator=generator, dtype=dtype, device=device)


def shifted_operand(A, B, shift, reg):
    """A + shift*B + reg*I (B=None -> A + shift*I) as a new operand."""
    if shift == 0.0 and reg == 0.0:
        return A
    A_sh = A
    if shift != 0.0:
        A_sh = A_sh.axpy(shift, B) if B is not None else A_sh.with_shifted_diagonal(shift)
    if reg != 0.0:
        A_sh = A_sh.with_shifted_diagonal(reg)
    return A_sh


def normalize_inverse(inv_result):
    """Inverse factories may return a plain callable ``X -> A^-1 X`` or a
    pair ``(aux, fn)`` with ``fn(aux, X)``. Normalize to the pair form."""
    if (
        isinstance(inv_result, tuple)
        and len(inv_result) == 2
        and callable(inv_result[1])
    ):
        return inv_result
    fn = lambda _aux, X: inv_result(X)  # noqa: E731
    fn.layout_t = getattr(inv_result, "layout_t", False)
    return None, fn


def _identity(g):
    return g


def _ritz_t(rayleigh_ritz: bool, Q: torch.Tensor, AQ: torch.Tensor, shift_, reduce_=_identity):
    """Ritz values (and rotated Q), transposed layout. ``rayleigh_ritz=False``
    gives the reference's per-vector Rayleigh quotients; True diagonalizes
    the m x m projected operator and rotates Q into the Ritz basis.
    ``reduce_`` sums the dots (or the Gram) over ranks."""
    if not rayleigh_ritz:
        return reduce_(dot_products_diagonal_t(Q, AQ)) - shift_, Q
    G = reduce_(AQ @ Q.T)
    G = 0.5 * (G + G.T)
    lam, V = torch.linalg.eigh(G)
    return lam - shift_, V.T @ Q


def _core(step, apply_a, Q0, nev, tol, maxiter, shift, block, ortho_iterations,
          rayleigh_ritz, descending, gram_reduce=None):
    """The loop of the reference's ``_largest_core`` (``step`` = A) and
    ``_inverse_core`` (``step`` = the inverse): ``Q <- ortho(step(Q))``,
    Ritz values from a product with A, stop on their largest change.
    ``gram_reduce``: the all-reduce of a row-sharded Q0 (local rows in,
    local rows of the eigenvectors out); ``None`` adds no operation."""
    dtype, dev = Q0.dtype, Q0.device
    shift_ = torch.tensor(shift, dtype=dtype, device=dev)
    reduce_ = gram_reduce or _identity

    def ortho(X):
        return orthonormalize_blocked_t(X, block=block, iterations=ortho_iterations,
                                        gram_reduce=gram_reduce)

    Q = ortho(Q0)
    s = torch.zeros((Q0.shape[0],), dtype=dtype, device=dev)
    distance = torch.tensor(float("inf"), dtype=dtype, device=dev)
    k = 0
    # the reference's loop: k in [0, maxiter), break when k >= 2 and
    # distance < tol
    while k < maxiter and (k < 2 or bool(distance >= tol)):
        Q = ortho(step(Q))
        s_new, Q = _ritz_t(rayleigh_ritz, Q, apply_a(Q), shift_, reduce_)
        distance = torch.max(torch.abs(s_new - s))
        s = s_new
        k += 1
    evals, evecs_t = sort_result_t(s, Q, nev, descending=descending)
    return EigenResult(
        eigenvalues=evals,
        eigenvectors=from_internal_vectors(evecs_t),
        iterations=torch.tensor(k, dtype=torch.int32),
        converged=distance < tol,
        criterion=distance,
        ortho_monitor=torch.zeros((), dtype=dtype, device=dev),
    )


def _start_block(A, q0, seed, m, dtype, hooked=False):
    """The (m, n) start block: ``q0`` as it is when a hook is set (the
    transposed (m, n_local) layout), else ``q0.T``; or a
    ``torch.Generator`` draw from ``seed`` on A's device."""
    if q0 is not None:
        return to_internal(q0 if hooked else q0.T)
    gen = torch.Generator(device=A.device).manual_seed(seed)
    return to_internal(random_multivector_t(gen, A.shape[0], m, dtype, A.device))


@reporting
def standard_largest(
    A,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    apply_a: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[torch.Tensor] = None,
    dtype=None,
) -> EigenResult:
    """Largest-nev eigenpairs of ``A x = lambda x`` by blocked orthogonal
    iteration (reference StandardLargest).

    Per iteration: Q2 = A' Q1; orthonormalize Q2; Rayleigh quotients via a
    second SpMM + per-vector dots; stop when max |lambda^k - lambda^{k-1}|
    < tol (after at least 2 iterations), where A' = A + shift*I.

    ``apply_a``/``gram_reduce`` (the JAX package's hooks, on the transposed
    (m, n_local) layout): the caller's product in place of A' (no operand
    setup runs; ``shift`` is then only subtracted from the Ritz values)
    and the reduction of every Gram and dot.

    ``q0``: the start block, m = nev rounded up to ``block``; default a
    ``torch.Generator`` draw from ``seed`` on A's device in ``dtype``
    (default A's). Its layout is the column layout (n, m) without hooks,
    and the transposed internal layout (m, n_local) when either hook is
    given, as in the JAX package.
    """
    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    hooked = apply_a is not None or gram_reduce is not None
    if apply_a is None:

        def _build():
            return make_engine(shifted_operand(A, None, shift, 0.0))[0]

        # engine routing and the shift fold memoized on operand identity
        A_int = memoized_setup((A,), ("std_large", float(shift)), _build)

        def apply_a(X):
            return spmm_t(A_int, X)

    Q0 = _start_block(A, q0, seed, m, dtype, hooked)
    with torch.no_grad():
        return _core(apply_a, apply_a, Q0, nev, float(tol), int(maxiter), float(shift),
                     int(block), int(ortho_iterations), bool(rayleigh_ritz), descending=True,
                     gram_reduce=gram_reduce)


@reporting
def standard_inverse(
    A,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    inverse: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
    q0: Optional[torch.Tensor] = None,
    dtype=None,
) -> EigenResult:
    """Smallest-nev eigenpairs of ``A x = lambda x`` by shift-invert inverse
    orthogonal iteration (reference StandardInverse).

    ``inverse``: factory mapping the shifted operator A' = A + shift*I to a
    multi-RHS solve: a plain callable or a pair ``(aux, fn)`` (see
    ``normalize_inverse``); column-layout solves are bridged to the
    internal transposed layout, those marked ``layout_t`` run on it as they
    are. Defaults to ``factorize.default_inverse_factory``, which picks the
    engine by the operand (the block-banded direct engine for bands up to
    2048, V-cycle-CG or Chebyshev-CG for wider DIA, RCM-banded for ELL/BSR).

    ``gram_reduce`` (the JAX package's hook): the reduction of every Gram
    and dot; ``q0`` is then in the transposed (m, n_local) layout, else in
    the column layout (n, m).
    """
    dtype = dtype or A.dtype
    m = padded_width(nev, block)
    if inverse is None:
        from dune_eigensolver_tpu_torch.factorize import default_inverse_factory

        inverse = default_inverse_factory

    def _build():
        A_int = make_engine(shifted_operand(A, None, shift, 0.0))[0]
        aux, fn = adapt_inverse(*normalize_inverse(inverse(A_int)))
        return A_int, aux, fn

    # setup memoized on operand identity (see generalized_inverse)
    A_int, inv_aux, inv_fn = memoized_setup((A, inverse), ("std_inv", float(shift)), _build)
    Q0 = _start_block(A, q0, seed, m, dtype, gram_reduce is not None)
    with torch.no_grad():
        return _core(lambda X: inv_fn(inv_aux, X), lambda X: spmm_t(A_int, X), Q0, nev,
                     float(tol), int(maxiter), float(shift), int(block),
                     int(ortho_iterations), bool(rayleigh_ritz), descending=False,
                     gram_reduce=gram_reduce)
