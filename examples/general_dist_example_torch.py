"""General-sparsity distributed solve with the PyTorch port: an unstructured
graph Laplacian (any scipy CSR) in RCM order, row-sharded over the ranks of
the process group, each rank's SpMM on the ELL kernel (K2) over its
halo-extended columns; a prebuilt plan reused across solves.

Run on one card (world size 1, NCCL), on the CPU (gloo), or over several
processes with torchrun (each rank on card LOCAL_RANK, or gloo with cpu):

    python examples/general_dist_example_torch.py [n] [device]
    torchrun --nproc-per-node=4 examples/general_dist_example_torch.py 20000 cpu
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dune_eigensolver_tpu_torch.dist import (  # noqa: E402
    init_distributed,
    make_mesh,
    sharded_generalized_inverse_general,
    sharded_standard_largest_general,
    windowed_shard_plan,
)
from dune_eigensolver_tpu_torch.dist.windowed import largest_operator  # noqa: E402
from dune_eigensolver_tpu_torch.sparse import problems, rcm_pencil  # noqa: E402


def _start_group(device):
    """torchrun's group where the launcher set one up, else world size 1 on
    a FileStore in a temporary directory."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device is None or device == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        return init_distributed(device, init_method="env://")
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    return init_distributed(device, store=store, rank=0, world_size=1)


def main():
    import scipy.sparse as sp

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    device = _start_group(sys.argv[2] if len(sys.argv) > 2 else None)
    mesh = make_mesh()
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    S = problems.unstructured_laplacian(n, extra_edges=n // 20, seed=5, fmt="scipy")
    A, _, _ = rcm_pencil(S, dtype=torch.float32, device="cpu")
    Sr = A.to_scipy().astype(np.float32)
    say(f"n={n} nnz={Sr.nnz} ranks={mesh.size} device={device}")

    # the rank's plan, built once: repeated solves skip the host planning
    plan = windowed_shard_plan(largest_operator(Sr), mesh.size, mesh.rank, device)
    for i in range(3):
        t0 = time.perf_counter()
        res = sharded_standard_largest_general(Sr, nev=4, tol=1e-8, maxiter=300, mesh=mesh,
                                               plan=plan)
        ev = res.eigenvalues.cpu().numpy()
        say(f"largest solve {i}: {time.perf_counter() - t0:.2f}s "
            f"iters={int(res.iterations)} evals={ev}")

    # shift-invert with the Schwarz per-rank banded inner solve
    B = sp.eye(n, dtype=np.float32, format="csr")
    t0 = time.perf_counter()
    res = sharded_generalized_inverse_general(Sr, B, nev=4, tol=1e-5, maxiter=100, shift=1e-3,
                                              mesh=mesh, inner="schwarz", cg_rtol=1e-6,
                                              cg_maxiter=200)
    say(f"generalized[schwarz]: {time.perf_counter() - t0:.2f}s "
        f"iters={int(res.iterations)} evals={np.sort(res.eigenvalues.cpu().numpy())[:4]}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
