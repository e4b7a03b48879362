"""Device time of the multigrid V-cycle's coarse tail as one kernel
(``kernels/mg_tail.py``) beside the eager tail's, at the north star's entries.

    python -m dune_eigensolver_tpu_torch.bench.mg_tail [--m 24] [--out FILE]

On the card only. For the bf16 V-cycle of each nested level of the north
star (54^3, 108^3, 216^3), the tail from the level the fit rule picks under
the card's limit (27^3, its couplings scaled by 4^-1, 4^-2, 4^-3), on a
seeded (m, 27, 27, 27) block of the 3D Laplacian's coefficients: the kernel
against the eager tail (the largest difference over the eager tail's
largest value), then, in turns, the kernel's device time by CUDA-graph
replay and launched in place (a loop of launches between two events), the
same with no CG step (the levels alone: the rest is the coarsest CG's chain
of 48 dependent steps), and the eager tail's device time a V-cycle (the sum
of its device operations under ``torch.profiler``, card activity only), its
wall time between two events and its count of device operations. One JSON
line a level, on stdout and appended to ``--out``; the first names the card
and its power limit. ``bytes`` is the least the tail moves, b read and the
correction written once.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

#: the north star's nested levels (``min_coarse`` 48: 54^3, 108^3, 216^3)
LEVELS = (54, 108, 216)


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"


def _profile(fn):
    """(device ms, device operations) of one ``fn()``, card activity only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time_total for e in ops) * 1e-3, len(ops)


def measure(m: int = 24):
    """The records described above, one a level of ``LEVELS``."""
    from dune_eigensolver_tpu_torch.bench.timing import replay_ms
    from dune_eigensolver_tpu_torch.factorize import multigrid as tmg
    from dune_eigensolver_tpu_torch.kernels import mg_tail as mt
    from dune_eigensolver_tpu_torch.sparse import problems

    dev = torch.device("cuda")
    A = problems.laplacian_dirichlet_3d(8, dtype=torch.float32, device=dev)
    _, a_fine, sigma = tmg._sampled_coeffs(A, (8, 8, 8))
    recs = []
    for N in LEVELS:
        levels = tmg._coarse_levels((N,) * 3, 6)
        start = mt.tail_start(levels, 1, torch.bfloat16, mt.smem_optin(dev))
        b = torch.from_numpy(np.random.default_rng(N).standard_normal((m,) + levels[start]))
        b = b.to(dev, torch.bfloat16)

        def tail(iters=48, kernel=True):
            fn = mt.mg_tail_cuda if kernel else mt.mg_tail_reference
            return fn(levels, start, b, a_fine, sigma, 1, 1, 0.8, iters)

        X, X_ref = tail(), tail(kernel=False)
        relmax = ((X.float() - X_ref.float()).abs().max() / X_ref.float().abs().max()).item()
        times = {"replay_ms": [], "inplace_ms": [], "levels_replay_ms": [], "eager_device_ms": [],
                 "eager_wall_ms": []}
        ops = None
        for _ in range(2):
            times["replay_ms"].append(replay_ms(tail))
            start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            tail()
            torch.cuda.synchronize()
            start_ev.record()
            for _ in range(20):
                tail()
            end_ev.record()
            torch.cuda.synchronize()
            times["inplace_ms"].append(start_ev.elapsed_time(end_ev) / 20)
            times["levels_replay_ms"].append(replay_ms(lambda: tail(iters=0)))
            device_ms, ops = _profile(lambda: tail(kernel=False))
            times["eager_device_ms"].append(device_ms)
            start_ev.record()
            for _ in range(3):
                tail(kernel=False)
            end_ev.record()
            torch.cuda.synchronize()
            times["eager_wall_ms"].append(start_ev.elapsed_time(end_ev) / 3)
        nbytes = 2 * b.numel() * b.element_size()
        rec = {"vcycle": f"{N}^3", "entry": list(levels[start]), "level": start, "m": m,
               "dtype": "bfloat16", "relmax": relmax, **{k: min(v) for k, v in times.items()},
               "eager_device_ops": ops, "kernel_device_ops": 1, "bytes": nbytes,
               "bytes_bound_ms": nbytes / 3.35e12 * 1e3,
               "smem_bytes": mt.tail_bytes(levels[start:], torch.bfloat16)}
        recs.append(rec)
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=24)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mg_tail: needs a CUDA device")
    _emit(args.out, {"card": _card(), "torch": torch.__version__, "m": args.m})
    for rec in measure(args.m):
        _emit(args.out, rec)


if __name__ == "__main__":
    main()
