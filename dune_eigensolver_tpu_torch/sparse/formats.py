"""Sparse matrix containers: frozen dataclasses over torch tensors.

Counterpart of ``dune_eigensolver_tpu/sparse/formats.py``:

* ``DIAMatrix`` — diagonal storage, the format of the stencil operators of
  the reference program: SpMM is a handful of shifted fused multiply-adds
  (``kernels/dia_spmm.py``). Offsets are plain Python ints so the kernel
  receives them by value.
* ``ELLMatrix`` — padded row storage (ELLPACK), the general-sparsity
  operand (unstructured CSR patterns).
* ``BSRMatrix`` — block-ELL: padded block rows of dense ``(br, bc)``
  blocks, the counterpart of ISTL's BCRS with ``FieldMatrix`` blocks
  (elasticity-type operators).

ELL and BSR keep the reference's padding contract: a padding slot holds the
row's own (block) index, clamped to the column range, and a zero
coefficient, so every gather stays in bounds and adds nothing.

``dia_from_numpy``/``ell_from_numpy``/``bsr_from_numpy`` are how operands
cross from the JAX package: pass ``np.asarray`` of a JAX container's arrays
and its static fields, and both packages compute on the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from dune_eigensolver_tpu_torch.utils.device import resolve


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
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        """Stored entries (incl. structural zeros inside the band)."""
        n = self.shape[0]
        return int(sum(n - abs(o) for o in self.offsets))

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


WARP_ROWS = 32  # consecutive rows that share one slot count (csrc/ell_spmm.cu ELL_WARP)


def ell_warp_slots(data: torch.Tensor, cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """One int32 count per ``WARP_ROWS`` consecutive rows of an ELL operand
    (the last group may be short): 1 + the last slot in which any of those
    rows holds a slot that is not padding, 0 for rows of padding alone.
    Padding is what the contract writes: ``data == 0`` and
    ``cols == min(row, n_cols - 1)``. Slots after a group's count are all
    padding, so a sum over the first ``count`` slots is the row's sum."""
    n, k = data.shape
    groups = -(-n // WARP_ROWS)
    if k == 0:
        return torch.zeros(groups, dtype=torch.int32, device=data.device)
    own = torch.arange(n, device=cols.device).clamp(max=n_cols - 1)
    stored = (data != 0) | (cols != own[:, None])
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=data.device)
    last = torch.where(stored, slot, 0).amax(dim=1)  # per row, 0 if none
    last = torch.nn.functional.pad(last, (0, groups * WARP_ROWS - n))
    return last.reshape(groups, WARP_ROWS).amax(dim=1).to(torch.int32)


def ell_column_offsets(cols: torch.Tensor):
    """``cols[i, j] - i`` as a contiguous ``(k, n)`` int16 stream when every
    such offset fits in int16, else None: a mesh- or RCM-ordered operator
    whose columns lie near their rows then feeds the CUDA kernel half the
    index bytes. Which of the two the kernel reads is decided here, from
    the container alone (``ELLMatrix.kernel_streams``)."""
    n, k = cols.shape
    if n == 0 or k == 0:
        return None
    off = cols.to(torch.int64) - torch.arange(n, device=cols.device)[:, None]
    if off.min().item() < -(2**15) or off.max().item() >= 2**15:
        return None
    return off.T.to(torch.int16).contiguous()


def _first_on_diagonal(on_diag: torch.Tensor) -> torch.Tensor:
    """The FIRST on-diagonal slot of each row: padding slots reuse the row's
    own index, so a shift must land on one slot only (real entries sort
    first)."""
    return on_diag & (torch.cumsum(on_diag.to(torch.int32), dim=1) == 1)


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK: every row padded to ``k`` entries.

    Padding entries have ``cols == min(row, ncols - 1)`` (an always-valid
    index) and ``data == 0``, so gathers stay in bounds and contribute
    nothing.
    """

    data: torch.Tensor  # (n, k)
    cols: torch.Tensor  # (n, k) int32
    shape: Tuple[int, int]
    nnz: int  # true nonzeros before padding

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @functools.cached_property
    def kernel_streams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The coefficients and one index stream as contiguous ``(k, n)``
        copies, made once per container: the CUDA kernel runs one thread per
        row, and in this layout a warp's coefficient and index loads are
        contiguous. The index stream is ``ell_column_offsets`` (int16
        ``cols - row``) where every offset fits, else the int32 columns."""
        offsets = ell_column_offsets(self.cols)
        return self.data.T.contiguous(), (self.cols.T.contiguous() if offsets is None else offsets)

    @functools.cached_property
    def column_stream(self) -> torch.Tensor:
        """``cols`` as a contiguous ``(k, n)`` int32 copy, made once on first
        use: what K2's first version (``experiments/gather_ablate.py``)
        reads. It is ``kernel_streams``' own index stream where that holds
        int32 columns; no solve path makes it otherwise."""
        index_t = self.kernel_streams[1]
        return index_t if index_t.dtype == torch.int32 else self.cols.T.contiguous()

    @functools.cached_property
    def warp_slots(self) -> torch.Tensor:
        """``ell_warp_slots`` of this container, made once: the CUDA kernel
        runs each warp's slot loop to its count, not to ``k``."""
        return ell_warp_slots(self.data, self.cols, self.shape[1])

    def _on_diag(self) -> torch.Tensor:
        n = self.shape[0]
        rows = torch.arange(n, dtype=self.cols.dtype, device=self.cols.device)
        return self.cols == rows[:, None]

    def diagonal(self) -> torch.Tensor:
        return torch.sum(torch.where(self._on_diag(), self.data, 0), dim=1)

    def with_shifted_diagonal(self, shift) -> "ELLMatrix":
        """A + shift*I as a new container. Rows lacking a diagonal entry get
        one in their first padding slot."""
        first = _first_on_diagonal(self._on_diag())
        shift = torch.as_tensor(shift, dtype=self.dtype, device=self.device)
        data = self.data + shift * first.to(self.dtype)
        return ELLMatrix(data=data, cols=self.cols, shape=self.shape, nnz=self.nnz)

    def axpy(self, alpha, other) -> "ELLMatrix":
        """self + alpha*other (host-side setup op, like the reference's
        ``A.axpy(shift, B)`` before factorization)."""
        S = self.to_scipy() + float(alpha) * other.to_scipy()
        return ell_from_scipy(S, dtype=self.dtype, k=self.k, device=self.device)

    def to_scipy(self):
        import scipy.sparse as sp

        n, _ = self.shape
        rows = np.repeat(np.arange(n), self.k)
        cols = self.cols.detach().cpu().numpy().reshape(-1)
        vals = self.data.detach().cpu().numpy().reshape(-1)
        return sp.csr_matrix((vals, (rows, cols)), shape=self.shape)


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-ELL storage: padded block rows of dense (br, bc) blocks.

    ``bcols`` is (nbr, k) int32 of block-column indices (padding: own block
    index, clamped, with a zero block), ``bdata`` is (nbr, k, br, bc).
    """

    bdata: torch.Tensor  # (nbr, k, br, bc)
    bcols: torch.Tensor  # (nbr, k) int32
    shape: Tuple[int, int]  # in scalar (unblocked) coordinates
    block: Tuple[int, int]  # (br, bc)
    nnz: int  # scalar nonzeros

    @property
    def nbr(self) -> int:
        return self.bdata.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.bdata.dtype

    @property
    def device(self) -> torch.device:
        return self.bdata.device

    @functools.cached_property
    def kernel_streams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(bdata, bcols)`` as contiguous ``(k, nbr, br, bc)`` and
        ``(k, nbr)`` copies, made once per container: a block is then
        ``br * bc`` contiguous values on a 16-byte boundary, and the CUDA
        kernel's one thread per block row reads each 2x2 block with one
        16-byte request (a 4x4 block with four), adjacent across the warp."""
        return self.bdata.transpose(0, 1).contiguous(), self.bcols.T.contiguous()

    def _first_on_diag(self):
        rows = torch.arange(self.nbr, dtype=self.bcols.dtype, device=self.bcols.device)
        on_diag = self.bcols == rows[:, None]
        return on_diag, _first_on_diagonal(on_diag)

    def _square(self, what: str) -> int:
        br, bc = self.block
        if br != bc:
            raise ValueError(f"{what}: needs square blocks")
        return br

    def diagonal(self) -> torch.Tensor:
        """Scalar diagonal of the blocked operator (requires br == bc)."""
        self._square("diagonal")
        on_diag, _ = self._first_on_diag()
        dblocks = torch.sum(
            torch.where(on_diag[..., None, None], self.bdata, 0), dim=1
        )  # (nbr, br, br)
        return torch.diagonal(dblocks, dim1=1, dim2=2).reshape(-1)

    def with_shifted_diagonal(self, shift) -> "BSRMatrix":
        br = self._square("with_shifted_diagonal")
        _, first = self._first_on_diag()
        eye = torch.eye(br, dtype=self.dtype, device=self.device)
        shift = torch.as_tensor(shift, dtype=self.dtype, device=self.device)
        bdata = self.bdata + shift * first[..., None, None].to(self.dtype) * eye
        return dataclasses.replace(self, bdata=bdata)

    def axpy(self, alpha, other) -> "BSRMatrix":
        """self + alpha*other (host-side setup op)."""
        S = self.to_scipy() + float(alpha) * other.to_scipy()
        return bsr_from_scipy(S, block=self.block, dtype=self.dtype, device=self.device)

    def to_scipy(self):
        import scipy.sparse as sp

        br, bc = self.block
        nbr, k = self.bcols.shape
        indptr = np.arange(nbr + 1) * k
        indices = self.bcols.detach().cpu().numpy().reshape(-1)
        data = self.bdata.detach().cpu().numpy().reshape(-1, br, bc)
        return sp.bsr_matrix((data, indices, indptr), shape=self.shape).tocsr()


# ---------------------------------------------------------------------------
# Converters (host-side setup; numpy in, tensors on ``device`` out;
# ``device=None`` is the current CUDA device, see ``utils/device.py``)
# ---------------------------------------------------------------------------


def _tensor(a, device, dtype) -> torch.Tensor:
    # a writable C-order copy: JAX arrays are read-only
    t = torch.from_numpy(np.array(a, order="C")).to(device=resolve(device))
    return t if dtype is None else t.to(dtype)


def dia_from_numpy(data, offsets, shape, device=None, dtype=None) -> DIAMatrix:
    """DIAMatrix from a row-indexed ``(ndiag, n)`` array (the layout of the
    JAX package's ``DIAMatrix.data``)."""
    offsets = tuple(int(o) for o in offsets)
    shape = tuple(int(s) for s in shape)
    if np.shape(data) != (len(offsets), shape[0]):
        raise ValueError(
            f"dia_from_numpy: data {np.shape(data)} does not match "
            f"{len(offsets)} offsets on n={shape[0]}"
        )
    return DIAMatrix(data=_tensor(data, device, dtype), offsets=offsets, shape=shape)


def ell_from_numpy(data, cols, shape, nnz, device=None, dtype=None) -> ELLMatrix:
    """ELLMatrix from ``(n, k)`` coefficient and column arrays (the layout,
    padding included, of the JAX package's ``ELLMatrix``)."""
    shape = tuple(int(s) for s in shape)
    if np.shape(data) != np.shape(cols) or np.shape(data)[0] != shape[0]:
        raise ValueError(
            f"ell_from_numpy: data {np.shape(data)} / cols {np.shape(cols)} "
            f"do not match n={shape[0]}"
        )
    return ELLMatrix(
        data=_tensor(data, device, dtype),
        cols=_tensor(np.asarray(cols, dtype=np.int32), device, None),
        shape=shape,
        nnz=int(nnz),
    )


def bsr_from_numpy(bdata, bcols, shape, block, nnz, device=None, dtype=None) -> BSRMatrix:
    """BSRMatrix from ``(nbr, k, br, bc)`` blocks and ``(nbr, k)`` block
    columns (the layout, padding included, of the JAX package's
    ``BSRMatrix``)."""
    shape = tuple(int(s) for s in shape)
    block = tuple(int(b) for b in block)
    nbr, k = np.shape(bcols)
    if np.shape(bdata) != (nbr, k) + block or nbr * block[0] != shape[0]:
        raise ValueError(
            f"bsr_from_numpy: bdata {np.shape(bdata)} / bcols {np.shape(bcols)} "
            f"do not match shape {shape} in {block} blocks"
        )
    return BSRMatrix(
        bdata=_tensor(bdata, device, dtype),
        bcols=_tensor(np.asarray(bcols, dtype=np.int32), device, None),
        shape=shape,
        block=block,
        nnz=int(nnz),
    )


def dia_from_scipy(A, dtype=None, device=None) -> DIAMatrix:
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


def ell_from_scipy(A, dtype=None, k=None, device=None) -> ELLMatrix:
    """Convert scipy sparse to ELL. ``k`` pads to at least that row width."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sort_indices()
    n, m = A.shape
    row_nnz = np.diff(A.indptr)
    kmax = int(row_nnz.max()) if n else 0
    if k is not None:
        kmax = max(kmax, k)
    cols = np.tile(np.minimum(np.arange(n), m - 1)[:, None], (1, kmax)).astype(np.int32)
    data = np.zeros((n, kmax), dtype=A.data.dtype)
    # vectorized fill: position within row for each nonzero
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)
    rows = np.repeat(np.arange(n), row_nnz)
    cols[rows, pos] = A.indices
    data[rows, pos] = A.data
    return ell_from_numpy(data, cols, (n, m), A.nnz, device=device, dtype=dtype)


def bsr_from_scipy(A, block: Tuple[int, int], dtype=None, device=None) -> BSRMatrix:
    """Convert scipy sparse to block-ELL with dense (br, bc) blocks."""
    import scipy.sparse as sp

    br, bc = block
    A = sp.bsr_matrix(sp.csr_matrix(A), blocksize=(br, bc))
    A.sort_indices()
    nbr = A.shape[0] // br
    row_nnz = np.diff(A.indptr)
    kmax = int(row_nnz.max()) if nbr else 0
    nbc = A.shape[1] // bc
    bcols = np.tile(np.minimum(np.arange(nbr), nbc - 1)[:, None], (1, kmax)).astype(np.int32)
    bdata = np.zeros((nbr, kmax, br, bc), dtype=A.data.dtype)
    pos_all = np.arange(A.indices.shape[0]) - np.repeat(A.indptr[:-1], row_nnz)
    rows_all = np.repeat(np.arange(nbr), row_nnz)
    bcols[rows_all, pos_all] = A.indices
    bdata[rows_all, pos_all] = A.data
    return bsr_from_numpy(
        bdata, bcols, A.shape, (br, bc), sp.csr_matrix(A).nnz, device=device, dtype=dtype
    )
