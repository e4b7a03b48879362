"""GenEO coarse-space setup with the PyTorch port: the smallest generalized
eigenpairs of the 2D GenEO pair with adaptive selection (the reference
driver's flagship use case, eigenvalues_test method 'raes',
src/dune-eigensolver.cc:475-500), on the CUDA card by default.

Run: python examples/geneo_example_torch.py [N] [threshold] [device]
     (device: cuda (default) or cpu)
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dune_eigensolver_tpu_torch.solvers import generalized_inverse_adaptive  # noqa: E402
from dune_eigensolver_tpu_torch.sparse import problems  # noqa: E402
from dune_eigensolver_tpu_torch.utils.printers import show_spectrum  # noqa: E402


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    threshold = float(sys.argv[2]) if len(sys.argv) > 2 else 0.5
    device = sys.argv[3] if len(sys.argv) > 3 else None  # None: the current CUDA device

    A = problems.laplacian_neumann_2d(N, dtype=torch.float32, device=device)
    B = problems.laplacian_b_2d(N, overlap=3, dtype=torch.float32, device=device)
    print(f"GenEO pair: n={A.shape[0]}, threshold={threshold}, device={A.device}")

    t0 = time.perf_counter()
    res, n_below = generalized_inverse_adaptive(
        A,
        B,
        threshold=threshold,
        nev=8,
        tol=2e-3,
        maxiter=400,
        shift=1e-3,
        rayleigh_ritz=True,
        verbose=1,
    )
    ev = res.eigenvalues.cpu().numpy()
    print(f"solved in {time.perf_counter() - t0:.2f}s, "
          f"{int(res.iterations)} iterations (last round)")
    show_spectrum(ev[: min(12, len(ev))])
    print(f"coarse space size (eigenvalues < {threshold}): {n_below}")
    return np.asarray(ev), n_below


if __name__ == "__main__":
    main()
