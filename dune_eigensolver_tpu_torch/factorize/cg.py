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
reference's. That is one host sync per CG iteration.

``gram_reduce`` (JAX ``factorize/cg.py:40``): for a row-sharded
multivector every row dot goes through it (an ``all_reduce`` SUM in the
distributed layer), so each rank takes the same stopping decision;
``apply_a`` is the caller's operator, the halo SpMM there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dune_eigensolver_tpu_torch.sparse.formats import BSRMatrix, DIAMatrix, ELLMatrix
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

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
    Returns (X, iterations).
    """
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
    k = 0
    while k < maxiter and bool(torch.any(torch.sqrt(rowdot(R, R)) > target)):
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
    x0: Optional[torch.Tensor] = None,
):
    """Column-layout wrapper over ``cg_solve_t``: B (n, m), apply_a on
    (n, m)."""
    X, k = cg_solve_t(
        lambda Xt: apply_a(Xt.T).T,
        B.T,
        inv_diag=None if diag is None else 1.0 / diag,
        rtol=rtol,
        maxiter=maxiter,
        x0=None if x0 is None else x0.T,
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


def _cg_solve_fn(rtol, maxiter, dtype=None):
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
        )
        return Y.to(out_dt)

    solve_pair.layout_t = True
    return solve_pair


def cg_inverse_factory(rtol: float = 1e-6, maxiter: int = 1000, dtype=None):
    """Factory of factories: returns an ``inverse=``/``precond=`` argument
    for the solvers. ``inverse(A_int)`` yields the pair
    ``((A_int, 1/diag(A_int)), fn)`` with a transposed-layout solve ``fn``
    whose inner SpMMs run the operand's kernel.

    ``dtype``: run the entire inner CG (operand stream, iterate, axpys) in
    this dtype, casting in and out at the boundary; dots still accumulate
    in f32. The returned direction is then preconditioner-grade. On a CUDA
    tensor only the DIA kernel takes bf16: the ELL and BSR kernels raise,
    as the TPU gather kernel does for sub-32-bit streams.
    """

    def inverse(A_int):
        return (A_int, _inv_diag_of(A_int)), _cg_solve_fn(rtol, maxiter, dtype)

    return inverse
