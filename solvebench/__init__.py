"""solvebench: the closed-loop benchmark of ``dune_eigensolver_tpu_torch``.

One run solves one cell's eigenproblem again and again for ``--seconds``
seconds and prints one JSON line (``run.py``). Everything that belongs to
one configuration, traffic mix, entry point, preconditioner, operand family,
reference or metric sits in a file of its own that ``registry.py`` finds by
name, so a cell, a metric or an operand family is added by adding files.
"""
