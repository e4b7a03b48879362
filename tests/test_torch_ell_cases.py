"""ELL operands whose warps of 32 rows stop at different slots, for the
tests of ``ELLMatrix.warp_slots`` on the CPU (tests/test_torch_gather_spmm.py)
and of the ELL kernel on the card (tests/test_torch_cuda.py). numpy, scipy
and the port only: the card's test file imports no JAX. The module holds
cases, not tests; its name puts it beside the files that import it."""

import numpy as np
import scipy.sparse as sp
import torch

from dune_eigensolver_tpu_torch.sparse import ell_from_scipy, problems

# rows of lengths 1..9 in one warp, the longest row at a warp's last lane, n
# no multiple of 32, ncols < n (padding clamped to ncols - 1), stored zeros
# on the diagonal before later entries (padding inside a row, which is
# computed), a diagonal that a shift wrote into a row's first padding slot,
# k = 1 with a warp of empty rows, and the graph Laplacian at n = 20,000
WARP_KINDS = ["graph20000", "lengths-1-to-k", "longest-at-last-lane", "n-1001", "rect",
              "interior", "shifted", "k1"]


def rows_csr(lengths, n_cols=None, seed=0):
    """A CSR operator whose row i holds ``lengths[i]`` entries at columns
    i, i+1, ... (mod n_cols), random nonzero values."""
    n = len(lengths)
    n_cols = n_cols or n
    g = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), lengths)
    cols = np.concatenate([(i + np.arange(L)) % n_cols for i, L in enumerate(lengths)])
    return sp.csr_matrix((g.uniform(0.5, 1.5, rows.size), (rows, cols)), shape=(n, n_cols))


def no_diagonal_at_5():
    """64 rows of 2 entries, but row 5 (the longest of its warp) holds 3 and
    not its diagonal."""
    S = rows_csr([4 if i == 5 else 2 for i in range(64)]).tolil()
    S[5, 5] = 0.0
    S = sp.csr_matrix(S)
    S.eliminate_zeros()
    return S


def interior_zeros():
    """Rows of 3..6 entries whose diagonal, first in the row, is a stored 0."""
    S = rows_csr([3 + i % 4 for i in range(200)], seed=1).tocoo()
    S.data[S.row == S.col] = 0.0
    return sp.csr_matrix((S.data, (S.row, S.col)), shape=S.shape)


def warp_operand(kind, device, dtype=None):
    """The port's ELLMatrix of ``kind`` (one of ``WARP_KINDS``)."""
    if kind == "graph20000":
        S = problems.unstructured_laplacian(20_000, extra_edges=1_000, seed=5, fmt="scipy")
    elif kind == "lengths-1-to-k":
        S = rows_csr([1 + i % 9 for i in range(64)])
    elif kind == "longest-at-last-lane":
        S = rows_csr([7 if i == 63 else 2 for i in range(96)])
    elif kind == "n-1001":
        S = sp.random(1001, 1001, density=0.004, random_state=3, format="csr") + sp.eye(1001)
    elif kind == "rect":
        S = sp.random(300, 117, density=0.03, random_state=4, format="csr")
    elif kind == "interior":
        S = interior_zeros()
    elif kind == "shifted":
        return ell_from_scipy(no_diagonal_at_5(), k=6, dtype=dtype,
                              device=device).with_shifted_diagonal(0.5)
    elif kind == "k1":
        d = np.arange(1.0, 101.0)
        d[32:64] = 0.0
        S = sp.diags(d).tocsr()
    else:
        raise KeyError(kind)
    return ell_from_scipy(S, dtype=dtype, device=device)
