"""Preconditioner kind ``cg``: the program's Jacobi-preconditioned CG on
A' as an approximate inverse (``factorize/cg.py::cg_inverse_factory``).
Options: ``rtol``, ``maxiter``."""

from __future__ import annotations


def factory(options: dict):
    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory

    return cg_inverse_factory(rtol=float(options["rtol"]), maxiter=int(options["maxiter"]))
