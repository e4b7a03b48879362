"""``rr.device_pct`` (%; layer ``solvers/lobpcg.py`` Rayleigh-Ritz; device
trace): as ``ortho.device_pct``, under the ``lobpcg.rr`` spans (the Gram,
``eigh`` and the rotations of X and P)."""

from pathlib import Path

from solvebench.program_trace import device_pct_under, measure

UNIT = "%"


def read(run):
    got = measure(run, Path(__file__).resolve().parents[1])
    return None if got is None else device_pct_under(got.ops, got.profiled, got.base_ns,
                                                     "lobpcg.rr")
