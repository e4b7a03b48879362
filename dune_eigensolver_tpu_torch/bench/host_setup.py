"""Host-LU setup seconds of one or more checkouts of the port, in turns.

    python -m dune_eigensolver_tpu_torch.bench.host_setup [--N 256] [--device cpu] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one, e.g. an older commit unpacked with ``git archive`` beside it). The
trees run in the order given and then in reverse (A, B, B, A), each in a
fresh process that imports that checkout's package, builds what it builds
at first use, and then times ``factorize/host_lu.py::lu_inverse_factory``
on the 2D Dirichlet Laplacian at N in f32 (SuperLU, the chunk schedules,
the tables' copy to the device), ending in a device sync. One ``SETUP``
line a run: the tree, the seconds, the factors' ``stats`` and chunk
counts; on the card then the card's name and power limit. Compare two
versions only within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from dune_eigensolver_tpu_torch.factorize import lu_inverse_factory
from dune_eigensolver_tpu_torch.sparse import problems
from dune_eigensolver_tpu_torch.utils import native

getattr(native, "load_host", lambda: None)()  # a tree with the host helper builds it first
N, device = int(sys.argv[2]), sys.argv[3]
A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=device)
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
sync()
t0 = time.perf_counter()
F, _ = lu_inverse_factory(A)
sync()
seconds = time.perf_counter() - t0
print(json.dumps(dict(seconds=seconds, stats=list(F.stats), chunks_L=F.L.nchunk,
                      chunks_U=F.U.nchunk)))
"""


def run(trees, N: int = 256, device: str = "cuda"):
    """One record a run, trees in the order given and then reversed."""
    out = []
    for tree in list(trees) + list(reversed(trees)):
        root = os.path.abspath(tree)
        r = subprocess.run([sys.executable, "-c", _CHILD, root, str(N), device],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"host_setup: {tree} failed:\n{r.stdout}{r.stderr}")
        out.append(dict(tree=tree, N=N, device=device,
                        **json.loads(r.stdout.strip().splitlines()[-1])))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--N", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for rec in run(args.trees, args.N, args.device):
        print("SETUP " + json.dumps(rec), flush=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
