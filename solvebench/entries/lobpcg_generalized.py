"""Entry point ``lobpcg_generalized``: ``dune_eigensolver_tpu_torch.solvers.
lobpcg_generalized``, preconditioned LOBPCG on the pencil (A, B).
``options`` are its keyword arguments; the start block of each solve is the
program's own draw from ``seed``."""

from __future__ import annotations


def build(ops: dict, options: dict, precond):
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized

    A, B = ops["A"], ops["B"]
    kw = dict(options)

    def solve(seed: int):
        return lobpcg_generalized(A, B, precond=precond, seed=seed, **kw)

    return solve
