"""Host-side sparse LU factorization carried to the device, with a
level-scheduled multi-RHS triangular solve there.

Counterpart of the JAX package's ``factorize/host_lu.py`` (itself the
counterpart of the reference's UMFPACK bridge and trisolve kernel):

* ``factorize``: scipy's SuperLU factorizes on the host (with our own row
  equilibration ``Rs``, UMFPACK-style), and the strict triangles of L and U
  are cut into *chunks*: fixed-size groups of rows of one dependency level,
  so every row of a chunk depends only on rows of earlier chunks.
* ``lu_solve``: scale, permute, then walk the chunks of L forward and of U
  backward; each chunk is one gather of the rows it depends on, one
  batched product, one scatter. The reference walks them in a
  ``lax.fori_loop``; here it is a Python loop over chunks (about five
  launches each).

Solve convention (verified against scipy): with Equil off,
``L @ U = A[pr_inv][:, pc_inv]``, so ``A^-1 b = w[pc]`` where
``L z = b[pr_inv]`` and ``U w = z``.

The level and chunk schedules run in the host helper the reference also
calls (``native/dunetpu.cpp``, copied to ``csrc/host/`` and built with g++
at first use by ``utils/native.py``); a failed build raises. The numpy
loops stay beside them as their plain versions (``_levels_from_csr_numpy``,
``_chunk_schedule_numpy``), which the tests hold the helper to bit for
bit; no path of the package calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dune_eigensolver_tpu_torch.utils import native
from dune_eigensolver_tpu_torch.utils.device import resolve


# ---------------------------------------------------------------------------
# Host-side scheduling
# ---------------------------------------------------------------------------


def _levels_from_csr(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Dependency level of each row of a (strict) triangular CSR matrix:
    lev[i] = 1 + max(lev[j] for j in row i's off-diagonal entries), by the
    host helper."""
    return native.levels_from_csr(indptr, indices)


def _chunk_schedule(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n: int,
    chunk: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Fixed-size row chunks that respect dependency levels, by the host
    helper. Returns (rows, cols, vals, kmax, nlev): rows (nchunk, chunk)
    int32 with pad=n; cols/vals (nchunk, chunk, kmax) with pad col=n, pad
    val=0; nlev the number of levels. ``data`` is float32 or float64."""
    sched = native.chunk_schedule(indptr, indices, data, n, chunk)
    if sched is None:
        raise TypeError(f"_chunk_schedule: values of dtype {data.dtype}, "
                        f"expected float32 or float64")
    return sched


def _levels_from_csr_numpy(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """The plain version of ``_levels_from_csr``: a loop over rows."""
    n = len(indptr) - 1
    lev = np.zeros(n, dtype=np.int32)
    for i in range(n):
        deps = indices[indptr[i] : indptr[i + 1]]
        if deps.size:
            lev[i] = lev[deps].max() + 1
    return lev


def _chunk_schedule_numpy(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n: int,
    chunk: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """The plain version of ``_chunk_schedule`` (the JAX package's numpy
    path), the same five results."""
    lev = _levels_from_csr_numpy(indptr, indices)
    order = np.argsort(lev, kind="stable")
    lev_sorted = lev[order]
    # chunk boundaries: never split across a level boundary
    boundaries = [0]
    start = 0
    for i in range(1, n + 1):
        if i == n or lev_sorted[i] != lev_sorted[start] or i - start == chunk:
            boundaries.append(i)
            start = i
    nchunk = len(boundaries) - 1

    row_nnz = np.diff(indptr)
    kmax = max(int(row_nnz.max()) if n else 0, 1)

    rows = np.full((nchunk, chunk), n, dtype=np.int32)
    cols = np.full((nchunk, chunk, kmax), n, dtype=np.int32)
    vals = np.zeros((nchunk, chunk, kmax), dtype=data.dtype)
    for c in range(nchunk):
        lo, hi = boundaries[c], boundaries[c + 1]
        rs = order[lo:hi]
        rows[c, : hi - lo] = rs
        for k, r in enumerate(rs):
            s, e = indptr[r], indptr[r + 1]
            cols[c, k, : e - s] = indices[s:e]
            vals[c, k, : e - s] = data[s:e]
    nlev = int(lev.max() + 1) if n else 0
    return rows, cols, vals, kmax, nlev


@dataclasses.dataclass(frozen=True)
class _TriFactor:
    rows: torch.Tensor  # (nchunk, C) int64, pad = n
    cols: torch.Tensor  # (nchunk, C, kmax) int64, pad = n
    vals: torch.Tensor  # (nchunk, C, kmax)
    nchunk: int


@dataclasses.dataclass(frozen=True)
class FactorizedMatrix:
    """LU factorization held on the device.

    Mirrors the members of the reference's UMFPackFactorizedMatrix: L
    (unit lower, chunk-scheduled), U (upper, chunk-scheduled), the row and
    column permutations, diag(U)^-1, and the row scaling ``rs`` (UMFPACK's
    Rs with do_recip=True: the factors hold diag(rs) A and the solve
    multiplies the right-hand side by rs first). ``stats`` = (nnz_L, nnz_U,
    levels_L, levels_U)."""

    L: _TriFactor
    U: _TriFactor
    dinv: torch.Tensor  # (n,) 1/diag(U)
    pr_inv: torch.Tensor  # (n,) int64: y = b[pr_inv]
    pc: torch.Tensor  # (n,) int64: x = w[pc]
    rs: Optional[torch.Tensor]  # (n,) row scaling Rs (None = identity)
    n: int
    stats: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.dinv.dtype


def _tri_factor(rows, cols, vals, device, dtype) -> _TriFactor:
    def idx(a):
        # int32 across, widened where it lands: the same int64 table for
        # half the host pass and half the bytes to the card
        return torch.from_numpy(a).to(device).to(torch.int64)

    return _TriFactor(rows=idx(rows), cols=idx(cols),
                      vals=torch.from_numpy(vals).to(device=device, dtype=dtype),
                      nchunk=rows.shape[0])


def _superlu(A, permc_spec: str, symmetric: bool, equilibrate: bool):
    """SuperLU of a scipy operand in f64, row-equilibrated first when
    ``equilibrate`` (``factorize``'s docstring). Returns ``(lu, rs)``, rs
    None without equilibration."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    A = sp.csc_matrix(A.astype(np.float64))
    rs = None
    if equilibrate:
        rowsum = np.asarray(abs(A).sum(axis=1)).ravel()
        if np.any(rowsum == 0.0):
            raise ZeroDivisionError("factorize: exactly zero row")
        rs = 1.0 / rowsum
        A = sp.csc_matrix(sp.diags(rs) @ A)
    lu = splu(A, permc_spec=permc_spec,
              options=dict(Equil=False, SymmetricMode=bool(symmetric)))
    if np.any(lu.U.diagonal() == 0.0):
        raise ZeroDivisionError("factorize: matrix is singular (zero U diagonal)")
    return lu, rs


def _strict_triangles(lu):
    """The strict lower triangle of SuperLU's L and the strict upper
    triangle of its U mirrored (i -> n-1-i), both CSR: U is solved
    bottom-up, so the mirror lets the same forward-level schedule serve."""
    import scipy.sparse as sp

    Lstrict = sp.tril(sp.csr_matrix(lu.L), k=-1, format="csr")
    Ustrict = sp.triu(sp.csr_matrix(lu.U), k=1, format="csr")
    return Lstrict, Ustrict[::-1, ::-1].tocsr()


def factorize(
    A,
    chunk: int = 512,
    permc_spec: str = "MMD_AT_PLUS_A",
    symmetric: bool = True,
    verbose: int = 0,
    dtype=None,
    equilibrate: bool = True,
    device=None,
) -> FactorizedMatrix:
    """Factorize a sparse operand on the host and carry it to the device.

    ``A``: a DIA/ELL/BSR container or a scipy sparse matrix. ``dtype`` (torch)
    of the factors: by default a DIA or ELL container's, else float32 (the
    reference's rule); ``device``: by default the container's, for scipy
    input the current CUDA device.

    ``equilibrate``: row-scale before factorizing, UMFPACK-style:
    Rs[i] = 1/sum|A[i,:]|, the factors hold Rs*A, and the solve applies Rs
    to the right-hand side first. SuperLU runs with Equil off (scipy does
    not hand out its own scaling), so the scaling is ours; it keeps f32
    factors accurate on ill-scaled operators. Raises ``ZeroDivisionError``
    on an exactly zero row or a zero pivot of U."""
    if hasattr(A, "to_scipy"):
        dtype = dtype or (A.data.dtype if hasattr(A, "data") else None)
        device = A.device if device is None else device
        A = A.to_scipy()
    device = resolve(device)
    dtype = dtype or torch.float32
    n = A.shape[0]
    lu, rs = _superlu(A, permc_spec, symmetric, equilibrate)
    udiag = lu.U.diagonal()
    Lstrict, Umir = _strict_triangles(lu)
    # f32 factors are packed in f32, as the reference does: the same
    # rounding as a cast on the device, half the table's bytes
    pack_dt = np.float32 if dtype == torch.float32 else np.float64
    rowsL, colsL, valsL, _, nlevL = _chunk_schedule(
        Lstrict.indptr, Lstrict.indices, Lstrict.data.astype(pack_dt), n, chunk)
    rowsU, colsU, valsU, _, nlevU = _chunk_schedule(
        Umir.indptr, Umir.indices, Umir.data.astype(pack_dt), n, chunk)
    # map the mirrored U back in place (pad n stays n)
    for a in (rowsU, colsU):
        np.subtract(n - 1, a, out=a, where=a < n)

    stats = (int(lu.L.nnz), int(lu.U.nnz), nlevL, nlevU)
    if verbose > 0:
        print(f"factorize: n={n} nnz(L)={stats[0]} nnz(U)={stats[1]} "
              f"levels L/U={nlevL}/{nlevU} chunks L/U={rowsL.shape[0]}/{rowsU.shape[0]}")

    def vec(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return FactorizedMatrix(
        L=_tri_factor(rowsL, colsL, valsL, device, dtype),
        U=_tri_factor(rowsU, colsU, valsU, device, dtype),
        dinv=vec(1.0 / udiag, dtype),
        pr_inv=vec(np.argsort(lu.perm_r), torch.int64),
        pc=vec(lu.perm_c, torch.int64),
        rs=None if rs is None else vec(rs, dtype),
        n=n,
        stats=stats,
    )


# ---------------------------------------------------------------------------
# Device-side solve
# ---------------------------------------------------------------------------


def _chunked_trisolve(F: _TriFactor, b: torch.Tensor, dinv: Optional[torch.Tensor]):
    """Solve a (unit-diagonal if dinv is None) triangular system whose
    strict part is chunk-scheduled in F. b: (n, m). Returns x: (n, m).

    x has one row more than b: the padding index n reads and writes it.
    Padding rows compute 0 - 0 there (zero right-hand side, zero
    coefficients, zero dinv), so the extra row stays zero and every
    duplicate write of it writes the same zero."""
    n, m = b.shape
    x = torch.zeros((n + 1, m), dtype=b.dtype, device=b.device)
    b_rows = torch.nn.functional.pad(b, (0, 0, 0, 1))[F.rows]  # (nchunk, C, m)
    if dinv is not None:
        b_scale = torch.nn.functional.pad(dinv, (0, 1))[F.rows][..., None]  # (nchunk, C, 1)
    for c in range(F.nchunk):
        deps = x[F.cols[c]]  # (C, kmax, m) gather
        xc = b_rows[c] - torch.einsum("ck,ckm->cm", F.vals[c], deps)
        if dinv is not None:
            xc = xc * b_scale[c]
        x.index_copy_(0, F.rows[c], xc)
    return x[:n]


def lu_solve(F: FactorizedMatrix, X: torch.Tensor) -> torch.Tensor:
    """Multi-RHS solve A^-1 X through the factors; X (n, m) in the factors'
    dtype. (Scale and) P-permute, L forward, U backward with the diagonal
    division, Q-permute."""
    if F.rs is not None:
        X = X * F.rs[:, None]
    Z = _chunked_trisolve(F.L, X[F.pr_inv], None)
    W = _chunked_trisolve(F.U, Z, F.dinv)
    return W[F.pc]


def lu_inverse_factory(A_sh, chunk: int = 512, **kw):
    """``inverse=`` factory for the solvers: factorize once on the host and
    return the pair ``(F, fn)`` with ``fn(F, Xt) = A^-1 X`` in the
    transposed (m, n) layout (``layout_t``), ``fn.engine == "host_lu"``.
    ``kw`` goes to ``factorize``."""
    return factorize(A_sh, chunk=chunk, **kw), _lu_solve_t


def _lu_solve_t(F: FactorizedMatrix, Xt: torch.Tensor) -> torch.Tensor:
    return lu_solve(F, Xt.T.to(F.dtype)).T.to(Xt.dtype).contiguous()


_lu_solve_t.layout_t = True
_lu_solve_t.engine = "host_lu"


__all__ = ["FactorizedMatrix", "factorize", "lu_inverse_factory", "lu_solve"]
