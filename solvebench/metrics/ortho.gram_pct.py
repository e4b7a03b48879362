"""``ortho.gram_pct`` (%; layer ``ops/ortho.py``; program counter): the share
of the orthonormalization's Grams and projections that ran as the
hand-written tall-skinny kernel (``kernels/ortho_gram.py``,
``csrc/ortho_gram.cu``), ``100 * ortho_gram_cuda.launches /
gram_product.calls``, over every solve of the run, read in the run's process
as ``mg.tail_pct`` is. None where the program has either counter missing
(no ``gram_product`` or no kernel) or counted no call."""

import importlib

UNIT = "%"


def read(run):
    ortho = importlib.import_module("dune_eigensolver_tpu_torch.ops.ortho")
    calls = getattr(getattr(ortho, "gram_product", None), "calls", 0)
    kernel = getattr(getattr(ortho, "ortho_gram", None), "ortho_gram_cuda", None)
    launches = getattr(kernel, "launches", None)
    if launches is None or not calls:
        return None
    return 100.0 * launches / calls
