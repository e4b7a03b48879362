"""``host.solve_s`` (s; layer: the entry point, one whole solve call; host
clock): the window's seconds over the solves completed in it, each ending
with its eigenvalues on the host: the time to a converged solve at the
cell's tolerance. Per layer, not end to end: the solve is bound by its
host's launch stream, and the host's speed swings by a tenth over seconds
(PERF.md §2)."""

from solvebench.yardstick import per_solve

UNIT = "s"


def read(run):
    return per_solve(run.window_s, len(run.solve_times)) if run.solve_times else None
