"""``device.idle_pct`` (%; layer device; device trace and host clock):
1 - the busy seconds of one solve profiled with the card's activity only
(the union of its device operations) over the mean unprofiled seconds per
solve of the same run's window. The profiler slows the host, so the
profiled solve's own wall time is no base for it."""

from solvebench.yardstick import per_solve

UNIT = "%"


def read(run):
    p = run.device_profile
    if p is None or not run.solve_times:
        return None
    return 100.0 * (1.0 - p.busy_s() / per_solve(run.window_s, len(run.solve_times)))
