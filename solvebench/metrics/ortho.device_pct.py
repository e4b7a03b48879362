"""``ortho.device_pct`` (%; layer ``ops/ortho.py``; device trace): in the
profiled solve of ``cg.idle_pct``, the device seconds of the operations
launched inside a ``lobpcg.ortho`` span (each operation's launch record,
by correlation id, placed in the innermost program span open at its start
on the trace's clock) over the device seconds of all its operations. None
where the program has no spans or the trace no launch records."""

from pathlib import Path

from solvebench.program_trace import device_pct_under, measure

UNIT = "%"


def read(run):
    got = measure(run, Path(__file__).resolve().parents[1])
    return None if got is None else device_pct_under(got.ops, got.profiled, got.base_ns,
                                                     "lobpcg.ortho")
