"""``nested.coarse_iterations`` (it/solve; layer ``solvers/lobpcg.py,
solvers/nested.py``; program counter): the LOBPCG iterations of the levels
below the fine grid a nested solve, from the program's
``lobpcg_nested.iterations`` (a ``Counter`` by depth below the fine grid,
0 the fine grid) over ``lobpcg_nested.calls``, over every solve of the
run, read in the run's process as ``cg.steps`` is. None where the program
does not count them or counted no nested solve."""

import importlib

UNIT = "it/solve"


def read(run):
    nested = importlib.import_module("dune_eigensolver_tpu_torch.solvers.nested").lobpcg_nested
    calls, levels = getattr(nested, "calls", 0), getattr(nested, "iterations", None)
    if levels is None or not calls:
        return None
    return sum(n for depth, n in levels.items() if depth > 0) / calls
