"""``solver.host_syncs`` (syncs/solve; layer ``solvers/`` with the host
loops of ``factorize/``; program counter): the operations that wait for the
card in one solve, its eigenvalues' read included, as torch's sync debug
mode counts them (``yardstick.count_syncs``)."""

UNIT = "syncs/solve"


def read(run):
    return None if run.syncs is None else float(run.syncs)
