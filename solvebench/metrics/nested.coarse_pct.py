"""``nested.coarse_pct`` (%; layer ``solvers/lobpcg.py, solvers/nested.py``;
device trace): in the profiled solve of ``program_trace.measure``, the
device seconds of the operations launched inside a ``nested.coarse`` span
(a coarse level's LOBPCG solve and the prolongation of its block to the
next level) over the device seconds of all its operations: the share of
the 54^3 and 108^3 levels. None where the program has no such span or the
trace no launch records."""

from pathlib import Path

from solvebench.program_trace import device_pct_under, measure

UNIT = "%"
SPAN = "nested.coarse"


def read(run):
    got = measure(run, Path(__file__).resolve().parents[1])
    if got is None or not any(s.name == SPAN for s in got.profiled):
        return None
    return device_pct_under(got.ops, got.profiled, got.base_ns, SPAN)
