"""``host.solve_p80_s`` (s; layer: the entry point, one whole solve call;
host clock): the 80th percentile by nearest rank of the seconds of every
solve completed in the window, each timed from its call to its eigenvalues
on the host. At 50 solves, the highest percentile with ten solves beyond
it. Per layer, for the reason ``host.solve_s`` gives."""

from solvebench.yardstick import nearest_rank

UNIT = "s"


def read(run):
    return nearest_rank(run.solve_times, 80) if run.solve_times else None
