"""Analytic roofline models: FLOP and byte counts for the hot kernels.

The reference converts wall time to GFLOP/s and arithmetic intensity with
hand-derived cost models (flops_orthonormalize kernels_cpp.hh:98-106,
bytes_orthonormalize_naive :108-116, bytes_orthonormalize_blocked :157-175;
SpMM flops = 2*n_iter*m*nnz, src/dune-eigensolver.cc:353-373). Same idea
here, with byte models of one streaming pass per operand (f32 by default).

Copy of the JAX package's ``bench/models.py``; no formula is changed.
"""

from __future__ import annotations


def flops_orthonormalize(n: int, m: int) -> float:
    """FLOPs of one blocked orthonormalization sweep: Gram + Cholesky-QR per
    block plus rank-b projections of the trailing blocks — asymptotically the
    same 2*n*m^2 as the reference's model (kernels_cpp.hh:98-106)."""
    return 2.0 * n * m * m


def bytes_orthonormalize_naive(n: int, m: int, itemsize: int = 4) -> float:
    """Column-at-a-time MGS traffic: column j streams j prior columns
    (reference kernels_cpp.hh:108-116) -> ~n*m^2/2 reads + n*m writes."""
    return itemsize * (0.5 * n * m * m + 2.0 * n * m)


def bytes_orthonormalize_blocked(
    n: int, m: int, block: int = 8, itemsize: int = 4
) -> float:
    """Blocked traffic: every b-block streams the finished prefix once
    (reference kernels_cpp.hh:157-175) -> n*m^2/(2b) + 3*n*m."""
    return itemsize * (0.5 * n * m * m / block + 3.0 * n * m)


def flops_spmm(nnz: int, m: int) -> float:
    """2 * m * nnz (reference src/dune-eigensolver.cc:353-354,372-373)."""
    return 2.0 * m * nnz


def bytes_spmm_dia(n: int, ndiag: int, m: int, itemsize: int = 4) -> float:
    """Speed-of-light DIA SpMM traffic: each diagonal read once, X read once,
    Y written once (the model bench.py's vs_baseline is defined against)."""
    return itemsize * (ndiag * n + 2.0 * n * m)


def bytes_spmm_ell(n: int, nnz_padded: int, m: int, itemsize: int = 4) -> float:
    """ELL SpMM traffic: values + int32 column indices + gathered X (worst
    case: one X row per nonzero) + Y."""
    return itemsize * (nnz_padded * (2.0 + m) + 2.0 * n * m)


def flops_trisolve_banded(nb: int, C: int, m: int) -> float:
    """Block-banded partitioned-inverse solve: per block row, k+1 dense
    (C,C)@(C,m) matmuls for forward + backward sweeps (factorize/banded.py)."""
    return 2 * nb * 2.0 * (2.0 * C * C * m)


def arithmetic_intensity(flops: float, nbytes: float) -> float:
    return flops / max(nbytes, 1.0)
