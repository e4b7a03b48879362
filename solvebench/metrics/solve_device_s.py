"""``solve_device_s`` (s, end to end, device trace): the seconds in which
the card ran some operation during one solve from the pool's first start
(the same solve in every run), profiled with the card's activity alone
after the window: the union of its device operations' intervals. It is the
card time a solve takes, which bounds the card's throughput when several
callers share it, and it does not follow the host's speed."""

UNIT = "s"


def read(run):
    p = run.device_profile
    return None if p is None or p.count == 0 else p.busy_s()
