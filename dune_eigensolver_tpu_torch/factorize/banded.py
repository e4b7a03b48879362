"""Block-banded direct factorization: the shift-invert engine for banded
(DIA) operands.

Counterpart of the JAX package's ``factorize/banded.py``. Every operator of
the reference program (2D 5-point / 3D 7-point Laplacians, the partition-of-
unity B) is banded in natural ordering, and a factorization of a banded
matrix fills only inside the band. So:

* **Setup** cuts the factor into ``C x C`` dense blocks: the subdiagonal
  blocks are kept as they are and every diagonal block is replaced by its
  explicit inverse (the partitioned-inverse method: the solve never runs a
  triangular solve). ``factorize_banded_device`` does this on the operand's
  device as a loop over block rows of cuSOLVER/LAPACK calls when the band
  fits one block (block-tridiagonal, LU with pivoting inside each diagonal
  block, or Cholesky); ``factorize_banded`` does it on the host in
  float64 (scipy's banded Cholesky, else a no-pivot banded LU in the host
  helper, ``utils/native.py``) for any band.
* **Solve** (``banded_solve``): a loop over block rows,
  ``x_i = Dinv_i @ (b_i - sum_j Sub_ij @ x_{i-j-1})``, dense (C, C) @ (C, m)
  products and nothing else; the backward sweep is the same loop on the
  reversed blocks. The reference runs it as one ``lax.scan``; here it is
  one ``addmm`` and one ``matmul`` call per block row and sweep.

Dense algebra is strict f32 (TF32 is off package-wide), as the reference's
``jax.default_matmul_precision("float32")``.

Memory: 2 * nb * (k + 1) * C^2 values, k = ceil(bw / C); the 2D Laplacian at
N = 256 (C = 256, nb = 256) holds 268 MB of f32 factors, at N = 1024
(C = 1024, nb = 1024) 17.2 GB, at N = 2048 137 GB, more than one card has.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t
from dune_eigensolver_tpu_torch.utils import native
from dune_eigensolver_tpu_torch.utils.device import resolve

#: widest band the device factorization takes; beyond it the (C, C) dense
#: blocks stop paying off (the reference's ``_DEVICE_BW_MAX``)
BANDED_BW_MAX = 2048


# ---------------------------------------------------------------------------
# Host-side band factorizations (numpy, f64)
# ---------------------------------------------------------------------------


def _band_from_dia(A) -> Tuple[np.ndarray, int, int]:
    """(band, bw, n) with band[b, i] = A[i, i - bw + b], b in [0, 2bw]."""
    offsets = A.offsets
    bw = max(abs(o) for o in offsets)
    n = A.shape[0]
    data = A.data.detach().cpu().to(torch.float64).numpy()
    band = np.zeros((2 * bw + 1, n))
    for d, o in enumerate(offsets):
        band[bw + o] = data[d]
    return band, bw, n


def _cholesky_banded(band: np.ndarray, bw: int, n: int) -> np.ndarray:
    """A = L L^T for SPD banded A. Returns lower band ``lb`` with
    lb[b, i] = L[i + b, i], b in [0, bw]. Raises LinAlgError if not SPD."""
    from scipy.linalg import cholesky_banded

    # scipy wants the upper band: ab[u + i - j, j] = A[i, j], i <= j
    ab = np.zeros((bw + 1, n))
    for b in range(bw + 1):  # superdiagonal b: A[i, i+b]
        ab[bw - b, b:] = band[bw + b, : n - b]
    cb = cholesky_banded(ab, lower=False)  # cb[bw + i - j, j] = R[i, j]
    # L = R^T: L[i + b, i] = R[i, i + b] = cb[bw - b, i + b]
    lb = np.zeros((bw + 1, n))
    for b in range(bw + 1):
        lb[b, : n - b] = cb[bw - b, b:]
    return lb


def _lu_banded(band: np.ndarray, bw: int, n: int):
    """No-pivot banded LU: A = L U with unit-diagonal L. Returns
    (lb, ub): lb[b, i] = L[i + b, i] (b in [1, bw], unit diagonal implied),
    ub[b, i] = U[i, i + b] (b in [0, bw]). Runs in the host helper the
    reference also calls (``utils/native.py::lu_banded``), which multiplies
    by 1/pivot where ``_lu_banded_numpy`` divides and may fuse the update
    into an FMA: the factors agree with the numpy loop's to ~1e-13 of
    max|band|, not bit for bit. Raises ``ZeroDivisionError`` at a zero
    pivot.

    Requires a no-pivot-stable matrix (diagonally dominant / SPD-like, as
    the shifted, regularized operators of the reference protocol are)."""
    work = _lu_band_work(band, bw, n)
    zp = native.lu_banded(work, n, bw)
    if zp >= 0:
        raise ZeroDivisionError(f"banded LU: zero pivot at row {zp}")
    return _lu_band_factors(work, bw, n)


def _lu_banded_numpy(band: np.ndarray, bw: int, n: int):
    """The plain version of ``_lu_banded``: vectorized rank-1 band updates
    in an O(n * bw) Python loop (the reference's numpy path)."""
    work = _lu_band_work(band, bw, n)
    for i in range(n):
        piv = work[bw, i]
        if piv == 0.0:
            raise ZeroDivisionError(f"banded LU: zero pivot at row {i}")
        r = min(bw, n - 1 - i)
        if r == 0:
            continue
        col = work[bw + 1 : bw + 1 + r, i] / piv  # L[i+1..i+r, i]
        work[bw + 1 : bw + 1 + r, i] = col
        # update trailing A[i+a, i+b] -= L[i+a,i] * U[i, i+b], stored at
        # work[bw + a - b, i + b]
        for b in range(1, r + 1):
            u = work[bw - b, i + b]  # U[i, i+b]
            if u != 0.0:
                work[bw + 1 - b : bw + 1 + r - b, i + b] -= col * u
    return _lu_band_factors(work, bw, n)


def _lu_band_work(band: np.ndarray, bw: int, n: int) -> np.ndarray:
    """The column-band f64 array work[bw + r, i] = A[i + r, i] =
    band[bw - r, i + r] both LU versions factorize in place."""
    work = np.zeros((2 * bw + 1, n))
    for r in range(-bw, bw + 1):
        if r >= 0:
            work[bw + r, : n - r] = band[bw - r, r:]
        else:
            work[bw + r, -r:] = band[bw - r, : n + r]
    return work


def _lu_band_factors(work: np.ndarray, bw: int, n: int):
    """(lb, ub) out of a factorized work array (``_lu_banded``)."""
    lb = np.zeros((bw + 1, n))
    ub = np.zeros((bw + 1, n))
    lb[0] = 1.0
    for b in range(1, bw + 1):
        lb[b, : n - b] = work[bw + b, : n - b]
    for b in range(bw + 1):
        ub[b, : n - b] = work[bw - b, b:]
    return lb, ub


# ---------------------------------------------------------------------------
# Block externalization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandedFactor:
    """One triangular factor in partitioned-inverse block form (lower,
    forward-substitution orientation; the upper factor is stored reversed).

    dinv: (nb, C, C)    — inverses of the diagonal blocks
    sub:  (nb, k, C, C) — subdiagonal blocks, sub[i, j] = T[blk i, blk i-1-j]
    """

    dinv: torch.Tensor
    sub: torch.Tensor
    nb: int
    C: int
    k: int


@dataclasses.dataclass(frozen=True)
class BandedFactorization:
    """A = L U (or L L^T) in block-banded partitioned-inverse form, on the
    operand's device. ``fwd`` solves L z = b top-down; ``bwd`` holds the
    upper factor flipped (rows and columns reversed) so the same forward
    sweep solves U x = z bottom-up. ``stats`` = (bw, C, nb, kind), kind
    ``"cholesky"`` or ``"lu"``."""

    fwd: BandedFactor
    bwd: BandedFactor
    n: int  # unpadded
    npad: int  # nb * C
    stats: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.fwd.dinv.dtype

    @property
    def nbytes(self) -> int:
        """Bytes of the four factor arrays (what one solve reads)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.fwd.dinv, self.fwd.sub, self.bwd.dinv, self.bwd.sub))


def _blocks_from_lower_band(lb: np.ndarray, bw: int, n: int, C: int):
    """Cut a lower-banded factor (lb[b, i] = L[i+b, i], b in [0, bw]) into
    partitioned-inverse blocks, float64 numpy: (dinv, sub, nb, npad, k)."""
    from scipy.linalg import solve_triangular

    nb = -(-n // C)
    npad = nb * C
    k = -(-bw // C)
    # pad the band to npad columns so gathers never go out of range; padded
    # diagonal entries are 1 (identity rows -> inverse stays identity)
    lbp = np.zeros((bw + 1, npad))
    lbp[:, :n] = lb
    lbp[0, n:] = 1.0

    a = np.arange(C)[:, None]  # block-local row
    b = np.arange(C)[None, :]  # block-local col
    r0 = (np.arange(nb) * C)[:, None, None]
    cols = r0 + b[None]  # (nb, C, C) global column index

    # diagonal blocks: L[r0+a, r0+b] = lb[a-b, r0+b] for 0 <= a-b <= bw
    d = (a - b)[None]
    valid = (d >= 0) & (d <= bw)
    dense = np.where(valid, lbp[np.clip(d, 0, bw), cols], 0.0)
    eye = np.eye(C)
    dinv = np.empty((nb, C, C))
    for i in range(nb):
        dinv[i] = solve_triangular(dense[i], eye, lower=True, unit_diagonal=False)

    # subdiagonal blocks: sub[i, j] = L[blk i, blk i-1-j];
    # L[r0+a, c0+b] with c0 = r0-(j+1)C -> band index (j+1)C + a - b
    sub = np.zeros((nb, k, C, C))
    for j in range(k):
        dj = (j + 1) * C + a - b
        validj = (dj <= bw) & (dj >= 0)
        cj = cols - (j + 1) * C
        cjc = np.clip(cj, 0, npad - 1)
        sub[:, j] = np.where(validj[None] & (cj >= 0), lbp[np.clip(dj, 0, bw)[None], cjc], 0.0)
    return dinv, sub, nb, npad, k


def factorize_banded(A, C: int = 256, dtype=None, verbose: int = 0) -> BandedFactorization:
    """Factorize a banded (DIA) operator on the host in float64 and move the
    blocks to the operand's device in ``dtype`` (default the operand's).

    Tries banded Cholesky first (SPD fast path), falls back to no-pivot
    banded LU. ``C`` is the block size (rounded up to a multiple of 128
    when C >= 128)."""
    band, bw, n = _band_from_dia(A)
    dtype = dtype or A.dtype
    if C >= 128:
        C = -(-C // 128) * 128
    kind = "cholesky"
    try:
        lb = _cholesky_banded(band, bw, n)
        ub = lb  # A = L L^T: U[i, i+b] = L[i+b, i] in transposed-band form
    except np.linalg.LinAlgError:
        kind = "lu"
        lb, ub = _lu_banded(band, bw, n)

    dinvF, subF, nb, npad, k = _blocks_from_lower_band(lb, bw, n, C)
    # the upper factor U (ub[b, i] = U[i, i+b]) solved bottom-up is a
    # forward solve on the reversed matrix over the full padded range
    # (padding rows are identity): Urev[p + b, p] = ubp[b, npad-1-p-b]
    ubp = np.zeros((bw + 1, npad))
    ubp[:, :n] = ub
    ubp[0, n:] = 1.0
    ub_rev = np.zeros_like(ubp)
    for b in range(bw + 1):
        ub_rev[b, : npad - b] = ubp[b, : npad - b][::-1]
    dinvB, subB, _, _, _ = _blocks_from_lower_band(ub_rev, bw, npad, C)

    F = banded_factorization_from_numpy(dinvF, subF, dinvB, subB, n, (bw, C, nb, kind),
                                        device=A.device, dtype=dtype)
    if verbose > 0:
        print(f"factorize_banded: n={n} bw={bw} kind={kind} C={C} nb={nb} k={k} "
              f"device factors {F.nbytes / 1e6:.0f} MB")
    return F


def banded_factorization_from_numpy(fwd_dinv, fwd_sub, bwd_dinv, bwd_sub, n, stats,
                                    device=None, dtype=None) -> BandedFactorization:
    """BandedFactorization from the four block arrays as numpy (the layout
    of the JAX package's ``BandedFactorization``: ``dinv`` (nb, C, C),
    ``sub`` (nb, k, C, C) for the forward and the reversed backward factor),
    its unpadded ``n`` and its ``stats``."""
    def tensor(a):
        t = torch.from_numpy(np.array(a, order="C")).to(device=resolve(device))
        return t if dtype is None else t.to(dtype)

    nb, k, C, _ = np.shape(fwd_sub)
    if np.shape(fwd_dinv) != (nb, C, C) or np.shape(bwd_dinv) != (nb, C, C):
        raise ValueError(f"banded_factorization_from_numpy: dinv {np.shape(fwd_dinv)} / "
                         f"{np.shape(bwd_dinv)} do not match sub {np.shape(fwd_sub)}")
    if not nb * C - C < n <= nb * C:
        raise ValueError(f"banded_factorization_from_numpy: n={n} does not fill {nb} blocks of {C}")
    return BandedFactorization(
        fwd=BandedFactor(dinv=tensor(fwd_dinv), sub=tensor(fwd_sub), nb=nb, C=C, k=k),
        bwd=BandedFactor(dinv=tensor(bwd_dinv), sub=tensor(bwd_sub), nb=nb, C=C,
                         k=np.shape(bwd_sub)[1]),
        n=int(n), npad=nb * C, stats=tuple(stats),
    )


# ---------------------------------------------------------------------------
# Device-side factorization
# ---------------------------------------------------------------------------
#
# When the band fits one block (bw <= C) the operator is block tridiagonal
# in C-blocks and the factorization runs on the operand's device as a loop
# over block rows of dense (C, C) operations: only the DIA diagonals are
# read, and nothing is read back to the host unless ``validate`` asks.


def _dia_to_block_tridiag(A, C: int, npad: int, nb: int, dtype):
    """(Aii, Asub, Asup), each (nb, C, C): the diagonal, sub- and
    superdiagonal blocks of a DIA operand with every |offset| <= C. Padding
    rows (n..npad) get an identity diagonal."""
    n = A.shape[0]
    dev = A.device
    a_idx = torch.arange(C, device=dev)
    Aii = torch.zeros((nb, C, C), dtype=dtype, device=dev)
    Asub = torch.zeros_like(Aii)
    Asup = torch.zeros_like(Aii)
    for d, o in enumerate(A.offsets):
        if abs(o) > C:
            raise ValueError(f"offset {o} exceeds block size {C}")
        row = torch.nn.functional.pad(A.data[d].to(dtype), (0, npad - n)).reshape(nb, C)
        # rows a with 0 <= a+o < C stay in the diagonal block
        lo, hi = max(0, -o), min(C, C - o)
        Aii[:, a_idx[lo:hi], a_idx[lo:hi] + o] += row[:, lo:hi]
        if o < 0:  # rows a < -o spill into the subdiagonal block (col C+a+o)
            Asub[:, a_idx[:-o], a_idx[:-o] + C + o] += row[:, :-o]
        elif o > 0:  # rows a >= C-o spill into the superdiagonal block
            Asup[:, a_idx[C - o:], a_idx[C - o:] - (C - o)] += row[:, C - o:]
    # the padding rows (fewer than C) all lie in the last block
    Aii[-1].diagonal().add_((a_idx >= n - (nb - 1) * C).to(dtype))
    return Aii, Asub, Asup


def _flip2(M):
    return M.flip(-2, -1)


def _device_cholesky(Aii, Asub):
    """Blocked Cholesky of a block-tridiagonal SPD matrix: ``(Linv, Lsub,
    dinvB, subB, info)`` with Linv_i = inv(L_ii), Lsub_i = L_{i,i-1}, and the
    backward factor's blocks written in place as the loop goes (reversed
    U = reversed L^T: dinvB[p] = flip2(Linv_q^T), subB[p] = flip2(Lsub_{q+1}^T),
    q = nb-1-p; subB[0] = 0). ``info`` sums cuSOLVER's per-block failure
    codes on the device (nonzero: not SPD); nothing syncs."""
    nb, C, _ = Aii.shape
    eye = torch.eye(C, dtype=Aii.dtype, device=Aii.device)
    Linv, Lsub = torch.empty_like(Aii), torch.empty_like(Aii)
    dinvB, subB = torch.empty_like(Aii), torch.empty_like(Aii)
    subB[0].zero_()
    info = torch.zeros((), dtype=torch.int32, device=Aii.device)
    Linv_prev = torch.zeros_like(eye)
    for i in range(nb):
        torch.matmul(Asub[i], Linv_prev.T, out=Lsub[i])
        S = torch.addmm(Aii[i], Lsub[i], Lsub[i].T, alpha=-1)
        Lii, info_i = torch.linalg.cholesky_ex(S)
        info += info_i
        torch.linalg.solve_triangular(Lii, eye, upper=False, out=Linv[i])
        Linv_prev = Linv[i]
        dinvB[nb - 1 - i] = _flip2(Linv[i].T)
        if i > 0:
            subB[nb - i] = _flip2(Lsub[i].T)
    return Linv, Lsub, dinvB, subB, info


def _device_block_lu(Aii, Asub, Asup):
    """Blocked LU of a block-tridiagonal matrix, partial pivoting *within*
    each diagonal block: ``(Dfwd, Lsub, dinvB, subB, info)`` for

      forward:  y_i = Dfwd_i @ (b_i - Lsub_i @ y_{i-1})    Dfwd_i = inv(L_i) P_i^T
      backward: x_i = Uinv_i @ (y_i - Usup_i @ x_{i+1})    Usup_i = Dfwd_i @ Asup_i

    with the backward blocks stored reversed as the loop goes (dinvB[p] =
    flip2(Uinv_q), subB[p] = flip2(Usup_q), q = nb-1-p; subB[0] = 0).

    The pivots: ``lax.linalg.lu`` (the reference) gives the composed row
    permutation ``perm`` with S[perm] = L U and forms inv(L) @ eye[perm];
    ``torch.linalg.lu_factor_ex`` gives LAPACK's sequential swaps, which
    ``torch.lu_unpack`` turns into P with S = P L U, so here the same
    matrix is inv(L) @ P^T. ``info`` sums the per-block codes (nonzero: an
    exactly singular U block); nothing syncs."""
    nb, C, _ = Aii.shape
    eye = torch.eye(C, dtype=Aii.dtype, device=Aii.device)
    Dfwd, Lsub = torch.empty_like(Aii), torch.empty_like(Aii)
    dinvB, subB = torch.empty_like(Aii), torch.empty_like(Aii)
    subB[0].zero_()
    info = torch.zeros((), dtype=torch.int32, device=Aii.device)
    Uinv_prev = Usup_prev = torch.zeros_like(eye)
    for i in range(nb):
        torch.matmul(Asub[i], Uinv_prev, out=Lsub[i])
        S = torch.addmm(Aii[i], Lsub[i], Usup_prev, alpha=-1)
        LU, pivots, info_i = torch.linalg.lu_factor_ex(S)
        info += info_i
        P, L, U = torch.lu_unpack(LU, pivots)
        torch.linalg.solve_triangular(L, P.T, upper=False, unitriangular=True, out=Dfwd[i])
        Uinv_prev = torch.linalg.solve_triangular(U, eye, upper=True)
        Usup_prev = Dfwd[i] @ Asup[i]
        dinvB[nb - 1 - i] = _flip2(Uinv_prev)
        if i < nb - 1:
            subB[nb - 1 - i] = _flip2(Usup_prev)
    return Dfwd, Lsub, dinvB, subB, info


def factorize_banded_device(
    A,
    C: int = 256,
    dtype=None,
    method: str = "auto",
    validate: bool = False,
    verbose: int = 0,
) -> BandedFactorization:
    """Factorization of a banded DIA operator on its own device.

    ``method``: ``'lu'`` (what ``'auto'`` takes: block LU with partial
    pivoting inside the diagonal blocks, for SPD and indefinite operators
    alike) or ``'cholesky'`` (SPD only; its blocks are garbage otherwise).
    ``'auto'`` picks LU because a choice at run time would read the device
    back mid-setup, as the reference reasons.

    ``validate``: read the per-block failure codes and a finiteness check
    back once after factorizing, and raise ``ZeroDivisionError`` on a
    failure (off by default: no host read). The block size is raised to
    cover the band (block tridiagonal needs bw <= C), then rounded up to a
    multiple of 128 when C >= 128."""
    band_bw = max(abs(o) for o in A.offsets)
    n = A.shape[0]
    dtype = dtype or A.dtype
    C = max(C, band_bw)
    if C >= 128:
        C = -(-C // 128) * 128
    nb = -(-n // C)
    npad = nb * C
    cholesky = method == "cholesky"
    with torch.no_grad():
        Aii, Asub, Asup = _dia_to_block_tridiag(A, C, npad, nb, dtype)
        if cholesky:
            dinvF, subF, dinvB, subB, info = _device_cholesky(Aii, Asub)
        else:
            dinvF, subF, dinvB, subB, info = _device_block_lu(Aii, Asub, Asup)
        del Aii, Asub, Asup
    if validate:
        ok_arr = dinvF[-1] if cholesky else dinvB[0]
        if int(info) != 0 or not bool(torch.isfinite(ok_arr).all()):
            raise ZeroDivisionError(
                "device factorization failed "
                + ("(operator not SPD?)" if cholesky else "(zero pivot block?)")
            )
    F = BandedFactorization(
        fwd=BandedFactor(dinv=dinvF, sub=subF[:, None], nb=nb, C=C, k=1),
        bwd=BandedFactor(dinv=dinvB, sub=subB[:, None], nb=nb, C=C, k=1),
        n=n, npad=npad, stats=(band_bw, C, nb, "cholesky" if cholesky else "lu"),
    )
    if verbose > 0:
        print(f"factorize_banded_device: n={n} bw={band_bw} kind={F.stats[3]} C={C} nb={nb}")
    return F


# ---------------------------------------------------------------------------
# The solve: a loop of dense block products
# ---------------------------------------------------------------------------


def _sweep(F: BandedFactor, B_blocks: torch.Tensor) -> torch.Tensor:
    """Solve T x = b for lower block-banded T given its partitioned-inverse
    blocks. B_blocks: (nb, C, m) -> x blocks (nb, C, m). Block row i costs
    min(i, k) ``addmm`` and one ``matmul`` (the reference's scan carries
    zeros into the first rows; skipping those products is the same sum)."""
    X = torch.empty_like(B_blocks)
    for i in range(F.nb):
        acc = B_blocks[i]
        for j in range(min(F.k, i)):
            acc = torch.addmm(acc, F.sub[i, j], X[i - 1 - j], alpha=-1)
        torch.matmul(F.dinv[i], acc, out=X[i])
    return X


def banded_solve(F: BandedFactorization, B: torch.Tensor) -> torch.Tensor:
    """Multi-RHS A^-1 B through the block-banded factors; B: (n, m) in the
    factors' dtype. Natural ordering needs no permutation: pad to npad,
    sweep forward, reverse, sweep the reversed backward factor, reverse,
    slice (the backward factor's padding rows are identity, so the padded
    rows stay zero and decouple)."""
    n, m = B.shape
    npad, C, nb = F.npad, F.fwd.C, F.fwd.nb
    Bp = torch.nn.functional.pad(B, (0, 0, 0, npad - n))
    Z = _sweep(F.fwd, Bp.reshape(nb, C, m))
    Zr = Z.reshape(npad, m).flip(0).reshape(nb, C, m)
    Xr = _sweep(F.bwd, Zr)
    return Xr.reshape(npad, m).flip(0)[:n]


def banded_solve_t(F: BandedFactorization, Xt: torch.Tensor) -> torch.Tensor:
    """``banded_solve`` in the solvers' transposed layout: Xt (m, n) in any
    float dtype -> contiguous (m, n) in Xt's dtype."""
    return banded_solve(F, Xt.T.to(F.dtype)).T.to(Xt.dtype).contiguous()


def refined_solve_fn(refine: int):
    """The solve of a banded pair ``((F, A_res), fn)``, transposed layout:
    ``fn(aux, Xt) = A^-1 X`` by one solve and ``refine`` steps of iterative
    refinement ``Y += solve(X - A Y)``, the residual's product through
    ``spmm_t`` (its CUDA kernel on the card). ``fn.engine`` names the
    engine for the caller who wants to know which one it got."""
    def solve(aux, Xt):
        F, A_res = aux
        Y = banded_solve_t(F, Xt)
        for _ in range(refine):
            Y = Y + banded_solve_t(F, Xt - spmm_t(A_res, Y))
        return Y

    solve.layout_t = True
    solve.engine = "banded"
    return solve


def banded_inverse_factory(A_sh, C: int = 256, refine: int = 1, **kw):
    """``inverse=`` factory for the solvers: factorize once (on the device
    when the band allows, else on the host) and return the pair
    ``((F, A_sh), fn)`` with ``fn(aux, Xt) = A^-1 X`` in the transposed
    layout (``layout_t``), ``fn.engine == "banded"`` and ``F.stats`` =
    (bw, C, nb, kind). ``refine``: iterative-refinement steps per apply,
    each one more solve and one product with ``A_sh`` (K1 on the card)."""
    bw = max(abs(o) for o in A_sh.offsets)
    if bw <= BANDED_BW_MAX:
        F = factorize_banded_device(A_sh, C=C, **kw)
    else:
        F = factorize_banded(A_sh, C=C, **kw)
    return (F, A_sh), refined_solve_fn(int(refine))


__all__ = [
    "BANDED_BW_MAX",
    "BandedFactor",
    "BandedFactorization",
    "banded_factorization_from_numpy",
    "banded_inverse_factory",
    "banded_solve",
    "banded_solve_t",
    "factorize_banded",
    "factorize_banded_device",
]
