"""``solver.iterations`` (it/solve; layer ``solvers/lobpcg.py``,
``solvers/nested.py``; program counter): the mean of
``EigenResult.iterations`` over the window's solves (for the nested solve,
the finest level's, as the result reports it)."""

UNIT = "it/solve"


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
