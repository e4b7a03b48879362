"""``cg.steps`` (steps/apply; layer ``factorize/cg.py``; program counter):
the program's ``cg_solve_t.steps`` over ``cg_solve_t.calls``, the CG steps
each Jacobi-CG preconditioner apply took, over every solve of the run: the
warm solve, the window's and the profiled ones (all the same problem from
the workload's pool), with the spans off; the other program readers' solves
run in a process of their own (``program_trace.py``). None where the
program does not count them."""

from solvebench.program_trace import steps_per_apply

UNIT = "steps/apply"


def read(run):
    return steps_per_apply()
