"""Matrix-free multi-RHS conjugate-gradient inverse application.

Counterpart of the JAX package's ``factorize/cg.py``: Jacobi-preconditioned
CG run simultaneously on all m right-hand sides (per-row step lengths), on
the transposed (m, n) multivector, so every inner SpMM runs the operand's
kernel through ``spmm_t``. Inverse iteration and LOBPCG tolerate inexact
inverse applications, so ``rtol`` can be far looser than the eigensolver
tolerance.

The reference's ``lax.while_loop`` is a Python loop here. Its condition,
``k < maxiter and any(row residual > rtol * row rhs norm)``, is read to the
host once per iteration, exactly as the reference decides it: no check is
skipped and no converged row is frozen, so the iterates are the
reference's. That is one host sync per CG iteration. While tracing is on
(``utils/vlog.py``) each solve is a ``cg.apply`` span and each read of the
condition a ``cg.stop`` span; ``cg_solve_t.calls`` and ``cg_solve_t.steps``
count the solves and their iterations, always, and ``cg_solve_t.fused`` the
solves that took the fused path.

The fused path (``_cg_fused``): for a CUDA iterate of f32 or f64 with the
Jacobi or no preconditioner, no ``gram_reduce`` and no ``x0``, the step's
vector algebra runs in the hand-written kernels of ``kernels/cg_step.py``,
with the step lengths and the stop flag kept on the card: a step is the
operator's SpMM, three kernels and the read of one flag. The arithmetic is
``_cg_loop``'s; only the summation order of the dots differs. Everything else
(the CPU, the distributed layer's hooks, a multigrid or Chebyshev
``precond_apply``, a bf16 inner solve) runs ``_cg_loop``.

``gram_reduce`` (JAX ``factorize/cg.py:40``): for a row-sharded
multivector every row dot goes through it (an ``all_reduce`` SUM in the
distributed layer), so each rank takes the same stopping decision;
``apply_a`` is the caller's operator, the halo SpMM there. The public
``cg_solve`` and ``cg_inverse_factory`` take both hooks as the JAX
package's do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dune_eigensolver_tpu_torch.kernels import cg_step
from dune_eigensolver_tpu_torch.sparse.formats import BSRMatrix, DIAMatrix, ELLMatrix
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t
from dune_eigensolver_tpu_torch.utils.vlog import span

_DATA_FIELD = {DIAMatrix: "data", ELLMatrix: "data", BSRMatrix: "bdata"}


def cg_solve_t(
    apply_a: Callable,
    B: torch.Tensor,
    inv_diag: Optional[torch.Tensor] = None,
    rtol: float = 1e-6,
    maxiter: int = 1000,
    x0: Optional[torch.Tensor] = None,
    precond_apply: Optional[Callable] = None,
    gram_reduce: Optional[Callable] = None,
):
    """Solve ``A X = B`` for SPD A, all rows of the transposed multivector
    simultaneously. B: (m, n).

    apply_a: Xt -> (A @ X)^T. inv_diag: (n,) reciprocal diagonal of A for
    Jacobi preconditioning. precond_apply: R -> M^-1 R, a fixed SPD
    preconditioner application; overrides the Jacobi default.
    gram_reduce: the reduction of every row dot for a sharded B.
    Returns (X, iterations), and adds 1 to ``cg_solve_t.calls`` (and to
    ``cg_solve_t.fused`` on the fused path) and the iterations to
    ``cg_solve_t.steps``.
    """
    fused = (precond_apply is None and gram_reduce is None and x0 is None
             and cg_step.takes(B, inv_diag))
    with span("cg.apply"):
        if fused:
            X, k = _cg_fused(apply_a, B, inv_diag, rtol, maxiter)
        else:
            X, k = _cg_loop(apply_a, B, inv_diag, rtol, maxiter, x0, precond_apply,
                            gram_reduce)
    cg_solve_t.calls += 1
    cg_solve_t.fused += fused
    cg_solve_t.steps += k
    return X, k


cg_solve_t.calls = 0
cg_solve_t.fused = 0
cg_solve_t.steps = 0


def _cg_fused(apply_a, B, inv_diag, rtol, maxiter):
    """``_cg_loop`` with the Jacobi or no preconditioner and no hooks, its
    vector algebra in the kernels of ``kernels/cg_step.py``. The same
    condition is read at the same place. The direction of a step is made at
    its start, so the last step's, which nothing reads, is never made."""
    d = None if inv_diag is None else inv_diag.contiguous()
    X, R, P, st = cg_step.cg_setup_cuda(B, d, rtol)

    def unconverged():
        with span("cg.stop"):
            return st.going()

    k = 0
    while k < maxiter and unconverged():
        if k:
            cg_step.cg_direction_cuda(R, P, d, st)
        AP = apply_a(P)
        cg_step.cg_pap_cuda(P, AP, st)
        cg_step.cg_update_cuda(X, R, P, AP, d, st)
        k += 1
    return X, k


def _cg_loop(apply_a, B, inv_diag, rtol, maxiter, x0, precond_apply, gram_reduce):
    """``cg_solve_t``'s iteration."""
    if precond_apply is not None:
        precond = precond_apply
    else:

        def precond(R):
            return R if inv_diag is None else R * inv_diag[None, :]

    # dots accumulate at >= f32 whatever the streamed dtype (bf16 -> f32,
    # f64 stays): a long bf16 sum would lose the residual norm entirely
    acc_dt = torch.promote_types(B.dtype, torch.float32)

    reduce_ = gram_reduce or (lambda g: g)

    def rowdot(U, V):
        return reduce_(torch.sum((U * V).to(acc_dt), dim=1))

    X = torch.zeros_like(B) if x0 is None else x0
    R = B - apply_a(X) if x0 is not None else B
    Z = precond(R)
    P = Z
    rz = rowdot(R, Z)
    bnorm = torch.sqrt(rowdot(B, B))
    # rows with zero rhs are converged by definition
    target = rtol * torch.where(bnorm > 0, bnorm, 1.0)

    def unconverged(R):
        going = torch.any(torch.sqrt(rowdot(R, R)) > target)
        with span("cg.stop"):
            return bool(going)

    k = 0
    while k < maxiter and unconverged(R):
        AP = apply_a(P)
        pap = rowdot(P, AP)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        # step lengths are in the accumulation dtype; cast at use so a
        # bf16 iterate stays bf16
        X = X + P * alpha.to(X.dtype)[:, None]
        R = R - AP * alpha.to(X.dtype)[:, None]
        Z = precond(R)
        rz_new = rowdot(R, Z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        P = Z + P * beta.to(X.dtype)[:, None]
        rz = rz_new
        k += 1
    return X, k


def cg_solve(
    apply_a: Callable,
    B: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    rtol: float = 1e-6,
    maxiter: int = 1000,
    gram_reduce: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
):
    """Column-layout wrapper over ``cg_solve_t``: B (n, m), apply_a on
    (n, m); ``gram_reduce`` reduces every row dot of a row-sharded B."""
    X, k = cg_solve_t(
        lambda Xt: apply_a(Xt.T).T,
        B.T,
        inv_diag=None if diag is None else 1.0 / diag,
        rtol=rtol,
        maxiter=maxiter,
        x0=None if x0 is None else x0.T,
        gram_reduce=gram_reduce,
    )
    return X.T, k


def _inv_diag_of(A_int):
    """Reciprocal diagonal of an operand, or None if it has none."""
    if hasattr(A_int, "diagonal"):
        return 1.0 / A_int.diagonal()
    return None


def _cast_floating(tree, dt):
    """Cast every floating tensor in ``tree`` (a tensor, a sparse container,
    or a tuple/list of these) to ``dt``; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dt) if tree.is_floating_point() else tree
    field = _DATA_FIELD.get(type(tree))
    if field is not None:
        return dataclasses.replace(tree, **{field: _cast_floating(getattr(tree, field), dt)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_floating(t, dt) for t in tree)
    return tree


def _cg_solve_fn(rtol, maxiter, dtype=None, gram_reduce=None):
    """The transposed-layout solve ``fn((A, inv_diag), Xt)``."""

    def solve_pair(aux, Xt):
        A_, d_ = aux
        out_dt = Xt.dtype
        if dtype is not None:
            # the whole inner CG in ``dtype``; the solver's operand is cast
            # per solve, as the reference does
            A_, d_, Xt = (
                _cast_floating(A_, dtype),
                None if d_ is None else d_.to(dtype),
                Xt.to(dtype),
            )
        Y, _ = cg_solve_t(
            lambda V: spmm_t(A_, V), Xt, inv_diag=d_, rtol=rtol, maxiter=maxiter,
            gram_reduce=gram_reduce,
        )
        return Y.to(out_dt)

    solve_pair.layout_t = True
    return solve_pair


def cg_inverse_factory(
    rtol: float = 1e-6,
    maxiter: int = 1000,
    gram_reduce: Optional[Callable] = None,
    apply_a: Optional[Callable] = None,
    dtype=None,
):
    """Factory of factories: returns an ``inverse=``/``precond=`` argument
    for the solvers. ``inverse(A_int)`` yields the pair
    ``((A_int, 1/diag(A_int)), fn)`` with a transposed-layout solve ``fn``
    whose inner SpMMs run the operand's kernel.

    ``gram_reduce``: the reduction of every row dot of the inner CG (a
    psum over row shards). ``apply_a``: the caller's operator on the
    transposed layout in place of the operand's ``spmm_t`` (the JAX
    package's hook); ``inverse(A_int)`` then returns a plain callable
    ``Xt -> A^-1 Xt`` (``layout_t``), Jacobi-preconditioned by the
    operand's diagonal when an operand is given and unpreconditioned for
    ``inverse(None)``, and ``dtype`` is not applied.

    ``dtype``: run the entire inner CG (operand stream, iterate, axpys) in
    this dtype, casting in and out at the boundary; dots still accumulate
    in f32. The returned direction is then preconditioner-grade. On a CUDA
    tensor only the DIA kernel takes bf16: the ELL and BSR kernels raise,
    as the TPU gather kernel does for sub-32-bit streams.
    """

    def inverse(A_int):
        if apply_a is not None:
            inv_diag = None if A_int is None else _inv_diag_of(A_int)

            def solve(Xt):
                Y, _ = cg_solve_t(apply_a, Xt, inv_diag=inv_diag, rtol=rtol,
                                  maxiter=maxiter, gram_reduce=gram_reduce)
                return Y

            solve.layout_t = True
            return solve
        return (A_int, _inv_diag_of(A_int)), _cg_solve_fn(rtol, maxiter, dtype, gram_reduce)

    return inverse
