"""``cg.fused_pct`` (%; layer ``factorize/cg.py``; program counter): the
share of the Jacobi-CG preconditioner applies that took the program's fused
path, ``100 * cg_solve_t.fused / cg_solve_t.calls``, over every solve of the
run, read in the run's process as ``cg.steps`` is. None where the program
does not count fused applies (no ``cg_solve_t.fused``) or counted no apply."""

import importlib

UNIT = "%"


def read(run):
    cg = importlib.import_module("dune_eigensolver_tpu_torch.factorize.cg").cg_solve_t
    calls, fused = getattr(cg, "calls", 0), getattr(cg, "fused", None)
    if fused is None or not calls:
        return None
    return 100.0 * fused / calls
