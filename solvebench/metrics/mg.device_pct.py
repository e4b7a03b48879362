"""``mg.device_pct`` (%; layer ``factorize/multigrid.py``; device trace):
device time launched inside the harness's range around each multigrid
preconditioner apply (``solvebench.precond.mg``), over the device time of
the same profiled solve. None where no such range holds device time."""

UNIT = "%"
RANGE = "solvebench.precond.mg"


def read(run):
    p = run.host_profile
    if p is None:
        return None
    under = p.under(RANGE)
    total = p.device_s()
    return 100.0 * under / total if under > 0 and total > 0 else None
