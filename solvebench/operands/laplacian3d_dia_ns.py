"""Operand family ``laplacian3d_dia_ns``: the north-star cell's family. Its
operand is ``laplacian3d_dia``'s, the 3D 7-point Dirichlet Laplacian made
on the card by diagonals: ``make``, ``to_port`` and ``offsets`` are that
module's own, found through the registry beside this file. The family has a
name of its own because its reference (``reference/laplacian3d_dia_ns.py``)
adds the closed-form control."""

from __future__ import annotations

from pathlib import Path

from solvebench import registry

_BASE = registry.operands("laplacian3d_dia", Path(__file__).resolve().parents[1])

make = _BASE.make
to_port = _BASE.to_port
offsets = _BASE.offsets
