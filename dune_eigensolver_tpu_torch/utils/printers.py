"""Debug/inspection printers for multivectors and sparse containers.

Reference: the ``show()`` family and ``operator<<`` in multivector.hh:148-233
(MultiVector, nested vectors, flat vectors, raw pointers), used throughout
the reference program for eyeballing intermediate state. Same spirit here for
tensors (moved to the host) and the sparse containers; small operands only
(full densify). Copy of the JAX package's ``utils/printers.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def show(obj, name: str = "", max_rows: int = 16, max_cols: int = 12, prec: int = 4):
    """Print a multivector (2D array), vector (1D array), or sparse
    container (densified) with aligned columns."""
    if hasattr(obj, "to_scipy"):  # sparse container
        dense = np.asarray(obj.to_scipy().todense())
        return show(dense, name or type(obj).__name__, max_rows, max_cols, prec)
    if hasattr(obj, "detach"):  # torch tensor, possibly on the card
        obj = obj.detach().cpu().numpy()
    arr = np.asarray(obj)
    if name:
        print(f"{name}: shape={arr.shape} dtype={arr.dtype}")
    if arr.ndim == 1:
        arr = arr[:, None].T
    nr, nc = arr.shape
    rr, cc = min(nr, max_rows), min(nc, max_cols)
    w = prec + 7
    for i in range(rr):
        row = " ".join(f"{arr[i, j]: {w}.{prec}e}" for j in range(cc))
        tail = " ..." if nc > cc else ""
        print(f"  [{i:4d}] {row}{tail}")
    if nr > rr:
        print(f"  ... ({nr - rr} more rows)")


def show_spectrum(
    eigenvalues,
    reference: Optional[np.ndarray] = None,
    name: str = "spectrum",
):
    """Print eigenvalues, optionally with per-eigenvalue errors against a
    reference (the error-table idiom of src/dune-eigensolver.cc:689-716)."""
    ev = np.asarray(eigenvalues, dtype=np.float64)
    print(f"{name}: {len(ev)} eigenvalues")
    for i, v in enumerate(ev):
        if reference is not None and i < len(reference):
            err = abs(v - reference[i])
            print(f"  lambda[{i:3d}] = {v: .12e}   |err| = {err:.3e}")
        else:
            print(f"  lambda[{i:3d}] = {v: .12e}")
    if reference is not None:
        k = min(len(ev), len(reference))
        print(f"  max error: {np.abs(ev[:k] - np.asarray(reference)[:k]).max():.3e}")
