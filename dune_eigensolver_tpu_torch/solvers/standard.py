"""Helpers shared by the solvers (the slice's subset of the JAX package's
``solvers/standard.py``; the ``standard_largest``/``standard_inverse``
entry points are not ported yet)."""

from __future__ import annotations

import torch


def padded_width(nev: int, block: int) -> int:
    """Round nev up to the block size."""
    return -(-nev // block) * block


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
