"""``mg.tail_pct`` (%; layer ``factorize/multigrid.py``; program counter):
the share of the V-cycle's coarse corrections whose tail ran as one kernel
(``kernels/mg_tail.py``, ``csrc/mg_tail.cu``), ``100 * mg_tail_cuda.launches
/ coarse_correction.applies``, over every solve of the run, read in the
run's process as ``cg.fused_pct`` is. None where the program has either
counter missing (no ``coarse_correction`` or no kernel) or counted no
apply."""

import importlib

UNIT = "%"


def read(run):
    mg = importlib.import_module("dune_eigensolver_tpu_torch.factorize.multigrid")
    applies = getattr(getattr(mg, "coarse_correction", None), "applies", 0)
    kernel = getattr(getattr(mg, "mg_tail", None), "mg_tail_cuda", None)
    launches = getattr(kernel, "launches", None)
    if launches is None or not applies:
        return None
    return 100.0 * launches / applies
