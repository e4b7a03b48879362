"""Entry point ``lobpcg_nested``: ``dune_eigensolver_tpu_torch.solvers.
lobpcg_nested``, nested-iteration LOBPCG over the coarse grids the program
derives from a structured DIA operand. ``options`` are its keyword
arguments; the start block of each solve comes from ``seed``, which the
nested solve forwards to its coarsest level's ``lobpcg_generalized``."""

from __future__ import annotations


def build(ops: dict, options: dict, precond):
    from dune_eigensolver_tpu_torch.solvers import lobpcg_nested

    A, B = ops["A"], ops["B"]
    kw = dict(options)

    def solve(seed: int):
        return lobpcg_nested(A, B, precond=precond, seed=seed, **kw)

    return solve
