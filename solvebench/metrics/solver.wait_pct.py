"""``solver.wait_pct`` (%; layer: the stop reads of ``solvers/lobpcg.py``
and ``factorize/cg.py``; host clock): over ``program_trace.SOLVES`` solves
from the pool's first start with the program's spans on, in a process no
profiler has run in (``program_trace.py``), the seconds inside the
``cg.stop`` and ``lobpcg.stop`` spans (the host blocked on the card in the
loops' one read a step) over the seconds inside the ``solve`` spans. None
where the program has no spans."""

from pathlib import Path

from solvebench.program_trace import measure, wait_pct

UNIT = "%"


def read(run):
    got = measure(run, Path(__file__).resolve().parents[1])
    return None if got is None else wait_pct(got.spans)
