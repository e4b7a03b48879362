"""Sparse matrix container: diagonal storage over a torch tensor.

Counterpart of ``dune_eigensolver_tpu/sparse/formats.py`` (DIA only; the
ELL and BSR containers are not ported yet). ``DIAMatrix`` is the format of
the stencil operators of the reference driver: SpMM is a handful of shifted
fused multiply-adds (``kernels/dia_spmm.py``). Offsets are plain Python ints
so the kernel receives them by value.

``dia_from_numpy`` is how operands cross from the JAX package: pass
``np.asarray(A.data)``, ``A.offsets`` and ``A.shape`` of a JAX ``DIAMatrix``
and both packages compute on the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Sparse matrix stored by diagonals.

    ``data[d, i]`` is the entry ``(i, i + offsets[d])``; entries whose column
    index falls outside ``[0, n)`` are stored as zero.
    """

    data: torch.Tensor  # (ndiag, n)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def diagonal(self) -> torch.Tensor:
        return self.data[self.offsets.index(0)]

    def with_shifted_diagonal(self, shift) -> "DIAMatrix":
        """A + shift*I as a new container (the operand is never mutated)."""
        d = self.offsets.index(0)
        data = self.data.clone()
        data[d] += torch.as_tensor(shift, dtype=data.dtype, device=data.device)
        return DIAMatrix(data=data, offsets=self.offsets, shape=self.shape)

    def axpy(self, alpha, other: "DIAMatrix") -> "DIAMatrix":
        """self + alpha*other. Requires pattern(other) ⊆ pattern(self)."""
        if not set(other.offsets) <= set(self.offsets):
            raise ValueError("axpy: other's diagonals must be a subset")
        data = self.data.clone()
        alpha = torch.as_tensor(alpha, dtype=data.dtype, device=data.device)
        for d_o, off in enumerate(other.offsets):
            data[self.offsets.index(off)] += alpha * other.data[d_o]
        return DIAMatrix(data=data, offsets=self.offsets, shape=self.shape)

    def to_scipy(self):
        import scipy.sparse as sp

        # ours is row-indexed (data[d, i] = A[i, i+o]); scipy's DIA is
        # column-indexed (data[d, j] = A[j-o, j]) — shift accordingly.
        n = self.shape[0]
        ours = self.data.detach().cpu().numpy()
        sdata = np.zeros_like(ours)
        for d, o in enumerate(self.offsets):
            if o >= 0:
                sdata[d, o:] = ours[d, : n - o] if o else ours[d]
            else:
                sdata[d, : n + o] = ours[d, -o:]
        return sp.dia_matrix(
            (sdata, np.asarray(self.offsets, dtype=np.int64)), shape=self.shape
        ).tocsr()


def dia_from_numpy(data, offsets, shape, device="cpu", dtype=None) -> DIAMatrix:
    """DIAMatrix from a row-indexed ``(ndiag, n)`` array (the layout of the
    JAX package's ``DIAMatrix.data``)."""
    data = np.array(data, order="C")  # a writable copy: JAX arrays are read-only
    offsets = tuple(int(o) for o in offsets)
    shape = tuple(int(s) for s in shape)
    if data.shape != (len(offsets), shape[0]):
        raise ValueError(
            f"dia_from_numpy: data {data.shape} does not match "
            f"{len(offsets)} offsets on n={shape[0]}"
        )
    t = torch.from_numpy(data).to(device=device)
    if dtype is not None:
        t = t.to(dtype)
    return DIAMatrix(data=t, offsets=offsets, shape=shape)


def dia_from_scipy(A, dtype=None, device="cpu") -> DIAMatrix:
    """Convert any scipy sparse matrix to DIAMatrix (host-side setup)."""
    import scipy.sparse as sp

    A = sp.dia_matrix(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("dia_from_scipy: matrix must be square")
    order = np.argsort(A.offsets)
    offsets = tuple(int(o) for o in A.offsets[order])
    n = A.shape[0]
    data = np.zeros((len(offsets), n), dtype=A.data.dtype)
    # scipy dia stores data[d, j] = entry at column j on diagonal offsets[d];
    # our convention indexes by row i (column = i + offset).
    for d, src in enumerate(order):
        o = offsets[d]
        rows = np.arange(0, n - o) if o >= 0 else np.arange(-o, n)
        data[d, rows] = A.data[src][rows + o]
    return dia_from_numpy(data, offsets, A.shape, device=device, dtype=dtype)
