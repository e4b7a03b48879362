"""The benchmark's yardstick, frozen here so that no change to the program
can move it: the card's published peaks, the least-bytes models of the
kernels, the window arithmetic, seed derivation and the sync count.

Sources of the frozen copies:

* ``bytes_spmm_dia``: ``dune_eigensolver_tpu_torch/bench/models.py:41``,
  unchanged (each diagonal read once, X read once, Y written once);
* ``bytes_bsr_least``: the K3 least-bytes count of the port's kernel table
  (PERF.md §6: the values, one int32 index a block, X and Y once);
* ``count_syncs``: ``chip_smoke.py::count_syncs`` (torch's sync debug
  mode, one warning per operation that waits for the card).
"""

from __future__ import annotations

import math
import warnings

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes per second (at 700 W)
HBM_BYTES_PER_S = 3.35e12

_MASK64 = (1 << 64) - 1


def bytes_spmm_dia(n: int, ndiag: int, m: int, itemsize: int = 4) -> float:
    """Speed-of-light DIA SpMM traffic: each diagonal read once, X read
    once, Y written once."""
    return itemsize * (ndiag * n + 2.0 * n * m)


def bytes_bsr_least(nnzb: int, n: int, m: int, itemsize: int = 4, block: int = 2,
                    index_bytes: int = 4) -> float:
    """Least bytes of one square-block BSR SpMM on an (n, n) operand with
    ``nnzb`` stored blocks: every block's values and one index once, X read
    once and Y written once. Padding slots are not counted."""
    return itemsize * (block * block * nnzb + 2.0 * n * m) + index_bytes * nnzb


def nearest_rank(values, pct: float) -> float:
    """The ``pct`` percentile by nearest rank: the smallest value with at
    least ``pct`` percent of the values at or below it."""
    if not values:
        raise ValueError("nearest_rank of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return ordered[rank - 1]


def per_solve(window_s: float, solves: int) -> float:
    """Seconds per solve: the window's seconds over the solves it completed."""
    if solves <= 0:
        raise ValueError("no solve completed in the window")
    return window_s / solves


def derive_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one use of ``--seed`` (splitmix64 over the seed and
    the stream's integers): the same seed always gives the same stream."""
    x = seed & _MASK64
    for part in stream:
        x = (x + 0x9E3779B97F4A7C15 + (part & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def count_syncs(torch, run) -> int:
    """Host syncs of one call of ``run`` (its result read to the host
    included), as torch's sync debug mode reports them: one warning for each
    operation that waits for the card."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run().eigenvalues.cpu()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))
