"""Blocked multivector orthonormalization and dot products.

Counterpart of the JAX package's ``ops/ortho.py``: the transposed-layout
functions, and the column-layout (n, m) wrappers over them. Each b-row
block of the (m, n) multivector is projected
against the finished prefix and then whitened by its Gram matrix —
CholeskyQR per block, with a spectral-whitening fallback when the
Cholesky fails.

Differences from the reference, none of which changes the result beyond
roundoff:

* the block sweep is a Python loop over row slices, and each block is
  projected against the finished rows only (the reference projects
  against a zero-filled full buffer inside ``lax.fori_loop``; the extra
  zero rows contribute exact zeros);
* small Cholesky factorizations use ``torch.linalg.cholesky_ex`` and
  ``solve_triangular`` (the reference's unrolled ``_small_chol`` works
  around TPU-specific XLA lowering);
* the fallback selects between the two (b, b) transforms with
  ``torch.where`` instead of ``lax.cond``; only the (b, b) transform
  branches, never the (b, n) blocks;
* ``gram_dtype`` accumulates each block's Gram, and computes its (b, b)
  whitening, in a wider type than the rows (the LOBPCG core's whole-basis
  ``ortho_block='full'`` asks for float64). The rows and their products
  stay in their own type.

Every Gram and projection of the block sweeps is one ``gram_product``
(``Y @ X^T`` of two row blocks): on CUDA rows it runs the hand-written
tall-skinny kernel (``kernels/ortho_gram.py``) wherever that kernel takes
the shape, the dtypes and the strides, and ``torch.matmul`` elsewhere; on
the CPU the plain version.

``gram_reduce`` (JAX ``ops/ortho.py:141, 189``): for a row-sharded
multivector, every Gram and projection matrix goes through it (the
distributed layer passes an ``all_reduce`` SUM, ``dist/sharded.py::
psum_reduce``). ``None`` adds no operation.
"""

from __future__ import annotations

import torch

from dune_eigensolver_tpu_torch.kernels import ortho_gram


def gram_product(Y: torch.Tensor, X: torch.Tensor, dtype=None) -> torch.Tensor:
    """``Y @ X.T`` (a, b) of the row blocks Y (a, n) and X (b, n), in
    ``dtype`` (default Y's): the tall-skinny kernel where
    ``ortho_gram.takes`` holds (CUDA rows, each contiguous along n at any row
    stride, of a type pair and an output it is built for), else the plain
    version, ``torch.matmul`` on the operands cast to ``dtype``. Counts its
    calls in ``gram_product.calls``."""
    gram_product.calls += 1
    if ortho_gram.takes(Y, X, dtype):
        return ortho_gram.ortho_gram_cuda(Y, X, dtype)
    return ortho_gram.ortho_gram_reference(Y, X, dtype)


gram_product.calls = 0


def dot_products_diagonal(Q1: torch.Tensor, Q2: torch.Tensor) -> torch.Tensor:
    """diag(Q1^T @ Q2): dot of each column of Q1 with same column of Q2."""
    return torch.sum(Q1 * Q2, dim=0)


def dot_products_all(Q1: torch.Tensor, Q2: torch.Tensor) -> torch.Tensor:
    """Full Gram matrix Q1^T @ Q2 (m x m), in strict f32 on the card (TF32
    is off package-wide, the reference's ``Precision.HIGHEST``)."""
    return Q1.T @ Q2


def dot_products_diagonal_t(Q1t: torch.Tensor, Q2t: torch.Tensor) -> torch.Tensor:
    """Per-vector dots in the transposed layout: diag(Q1 Q2^T), (m,)."""
    return torch.sum(Q1t * Q2t, dim=1)


def _whiten_apply(Gr: torch.Tensor, eps: float, Xs: tuple) -> tuple:
    """Apply the block-whitening transform of the (floored) Gram ``Gr`` to
    every tensor in ``Xs``: ``chol(Gr)^-1 @ Xi`` (CholeskyQR), or, when the
    Cholesky fails, the spectral whitening ``diag(w^-1/2) V^T @ Xi`` with
    the eigenvalues clipped at a relative floor. Healthy directions are
    orthonormalized exactly as CholeskyQR would; defective ones become
    bounded noise rows, and an all-zero block stays zero."""
    b = Gr.shape[0]
    L, info = torch.linalg.cholesky_ex(Gr)
    eye = torch.eye(b, dtype=Gr.dtype, device=Gr.device)
    t_chol = torch.linalg.solve_triangular(L, eye, upper=False)
    w, V = torch.linalg.eigh(Gr)
    floor = max(eps, 1e-7) * torch.clamp(torch.trace(Gr) / b, min=1e-30)
    # T = diag(w^-1/2) V^T  =>  T Gr T^T = I on the clipped spectrum
    t_eig = (V / torch.sqrt(torch.maximum(w, floor))[None, :]).T
    ok = (info == 0) & torch.isfinite(L).all()
    T = torch.where(ok, t_chol, t_eig)
    return tuple(T.to(Xi.dtype) @ Xi for Xi in Xs)


def _floored(G: torch.Tensor, eps: float) -> torch.Tensor:
    """Symmetrize G and add the tiny relative regularization that guards
    the Cholesky against a rank-deficient block."""
    b = G.shape[0]
    G = 0.5 * (G + G.T)
    eye = torch.eye(b, dtype=G.dtype, device=G.device)
    return G + eps * torch.trace(G) / b * eye


def _chol_normalize_t(Xk: torch.Tensor, G: torch.Tensor, eps: float) -> torch.Tensor:
    """chol(G)^-1 @ Xk for SPD G (transposed-layout CholeskyQR step)."""
    return _whiten_apply(_floored(G, eps), eps, (Xk,))[0]


def _identity(g):
    return g


def orthonormalize_blocked_t(
    Xt: torch.Tensor,
    block: int = 8,
    iterations: int = 1,
    eps: float = 0.0,
    gram_reduce=None,
) -> torch.Tensor:
    """Orthonormalize the rows of the transposed multivector Xt (m, n)
    block by block (CholeskyQR per block + projection of later blocks
    against the finished prefix). ``gram_reduce``: applied to every Gram
    and projection matrix of a row-sharded Xt."""
    m, _ = Xt.shape
    if m % block != 0:
        raise ValueError(f"orthonormalize_blocked_t: m={m} not multiple of {block}")
    reduce_ = gram_reduce or _identity
    for _ in range(iterations):
        out = torch.empty_like(Xt)
        for k in range(0, m, block):
            Xk = Xt[k : k + block]
            if k:
                done = out[:k]
                S = reduce_(gram_product(done, Xk))  # (k, b)
                Xk = Xk - S.T @ done
            G = reduce_(gram_product(Xk, Xk))
            out[k : k + block] = _chol_normalize_t(Xk, G, eps)
        Xt = out
    return Xt


def orthonormalize_blocked(
    X: torch.Tensor,
    block: int = 8,
    gram_reduce=None,
    iterations: int = 1,
    eps: float = 0.0,
) -> torch.Tensor:
    """Column-layout wrapper over ``orthonormalize_blocked_t``: X is (n, m)
    and its columns come back orthonormal. ``gram_reduce``: applied to
    every Gram and projection matrix of a row-sharded X."""
    return orthonormalize_blocked_t(
        X.T.contiguous(), block=block, iterations=iterations, eps=eps,
        gram_reduce=gram_reduce,
    ).T


def b_orthonormalize_blocked_t(
    b_op,
    Xt: torch.Tensor,
    block: int = 8,
    iterations: int = 1,
    eps: float = 0.0,
    return_mass: bool = False,
    gram_reduce=None,
    gram_dtype=None,
):
    """B-orthonormalize the rows of Xt (m, n): on return X B X^T = I.

    ``b_op`` is a sparse operand (anything ``spmm_t`` accepts) or a callable
    ``Xt -> (B @ X)^T``. Returns ``(Xt, norm)``: ``norm`` is the largest
    absolute off-diagonal Gram or projection coefficient seen, the
    loss-of-orthogonality monitor. ``return_mass=True`` also returns the
    per-vector B-mass ``diag(Gram)`` after projection and before
    normalization, from the first sweep. ``P = B @ (block)`` is recomputed
    per block, so it reflects earlier projections, and kept consistent
    through the block's normalization. ``gram_reduce``: applied to every
    Gram and projection matrix of a row-sharded Xt. ``gram_dtype``: the
    type each block's Gram is accumulated in and its whitening computed in
    (default Xt's).
    """
    from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

    apply_b = b_op if callable(b_op) else (lambda V: spmm_t(b_op, V))
    m, _ = Xt.shape
    if m % block != 0:
        raise ValueError(f"b_orthonormalize_blocked_t: m={m} not multiple of {block}")
    reduce_ = gram_reduce or _identity
    gd = gram_dtype or Xt.dtype
    offdiag = ~torch.eye(block, dtype=torch.bool, device=Xt.device)
    norm = torch.zeros((), dtype=Xt.dtype, device=Xt.device)
    mass = torch.zeros((m,), dtype=Xt.dtype, device=Xt.device)

    for sweep in range(iterations):
        bufx = torch.empty_like(Xt)
        bufp = torch.empty_like(Xt) if m > block else None
        mass_sweep = torch.empty((m,), dtype=Xt.dtype, device=Xt.device)
        for k in range(0, m, block):
            Xk = Xt[k : k + block]
            if k:
                # project against finished blocks via their B-images
                S = reduce_(gram_product(bufp[:k], Xk))  # (k, b)
                norm = torch.maximum(norm, S.abs().max())
                Xk = Xk - S.T @ bufx[:k]
            Pk = apply_b(Xk)
            G = reduce_(gram_product(Pk, Xk, gd))
            norm = torch.maximum(norm, torch.where(offdiag, G, 0).abs().max().to(norm.dtype))
            mass_sweep[k : k + block] = torch.diagonal(G)
            Xk, Pk = _whiten_apply(_floored(G, eps), eps, (Xk, Pk))
            bufx[k : k + block] = Xk
            if bufp is not None:
                bufp[k : k + block] = Pk
        Xt = bufx
        if sweep == 0:
            mass = mass_sweep
    if return_mass:
        return Xt, norm, mass
    return Xt, norm


def b_orthonormalize_blocked(
    b_op,
    X: torch.Tensor,
    block: int = 8,
    gram_reduce=None,
    iterations: int = 1,
    eps: float = 0.0,
    return_mass: bool = False,
):
    """Column-layout wrapper over ``b_orthonormalize_blocked_t``: X is
    (n, m), ``b_op`` a sparse operand or a callable on (n, m);
    ``gram_reduce`` as there."""
    apply_b_t = (lambda Vt: b_op(Vt.T).T) if callable(b_op) else b_op
    out = b_orthonormalize_blocked_t(
        apply_b_t, X.T.contiguous(), block=block, iterations=iterations, eps=eps,
        return_mass=return_mass, gram_reduce=gram_reduce,
    )
    return (out[0].T, *out[1:])
