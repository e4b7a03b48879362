"""A kernel's share of the card's memory roofline in one profiled solve.

The bytes are the least the work needs (``yardstick``'s models at each
call's operand, block and dtype, as ``spans.py`` recorded the calls into
the kernel's wrapper); the time is the device time of the trace's records
of the kernel, found by name. Each record is tied to its call through the
harness's range around the call (``solvebench.launch.<i>``); a record the
trace does not tie to a call counts neither its bytes nor its time.
"""

from __future__ import annotations

from solvebench.yardstick import HBM_BYTES_PER_S

PREFIX = "solvebench.launch."


def _call_index(stack):
    for name in reversed(stack or ()):
        if name.startswith(PREFIX):
            return int(name[len(PREFIX):])
    return None


def hbm_pct(run, wrapper: str, kernel_names, least_bytes):
    """Percent of ``HBM_BYTES_PER_S`` that the kernel's least bytes over its
    device time make, or None where the solve launched it no time. Each
    call's bytes count once, however many records the call launched; its
    time is the sum over them."""
    p = run.host_profile
    if p is None:
        return None
    calls, seconds = set(), 0.0
    for op in p.ops:
        i = _call_index(op.stack)
        if i is not None and any(k in op.name for k in kernel_names):
            if run.launches[i]["kernel"] == wrapper:
                calls.add(i)
                seconds += op.dur / 1e6
    nbytes = sum(least_bytes(run.launches[i]) for i in calls)
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds if seconds > 0 else None
