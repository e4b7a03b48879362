"""``cg.idle_pct`` (%; layer ``factorize/cg.py``; device trace): in one
solve from the pool's first start with the program's spans on, profiled
with the card's activity alone after ``solver.wait_pct``'s solves in their
process (``program_trace.py``), the share of the card's idle seconds (the
gaps between the union of its operations) that fall while the host is
inside a ``cg.apply`` span, on the trace's clock. A share, not seconds: the
profiler slows the host. The card's times sit within some tens of us of the
host's (an offset the profiler sets in each process: -65 to +9 us on an
H100), small against a ``cg.apply`` of tens of ms. None where the program
has no spans or the profile no device operation."""

from pathlib import Path

from solvebench.program_trace import idle_pct_inside, measure

UNIT = "%"


def read(run):
    got = measure(run, Path(__file__).resolve().parents[1])
    return None if got is None else idle_pct_inside(got.ops, got.profiled, got.base_ns,
                                                    "cg.apply")
