"""``mg.coarse_pct`` (%; layer ``factorize/multigrid.py``; device trace): in
the profiled solve of ``program_trace.measure``, the device seconds of the
operations launched inside an ``mg.coarse`` span (a V-cycle's restriction,
its levels below the fine one with the coarsest CG, and its prolongation)
over the device seconds of all its operations. None where the program has
no such span or the trace no launch records."""

from pathlib import Path

from solvebench.program_trace import device_pct_under, measure

UNIT = "%"
SPAN = "mg.coarse"


def read(run):
    got = measure(run, Path(__file__).resolve().parents[1])
    if got is None or not any(s.name == SPAN for s in got.profiled):
        return None
    return device_pct_under(got.ops, got.profiled, got.base_ns, SPAN)
