"""Device time of one Jacobi-CG apply on the fused path (``kernels/cg_step.py``)
beside the plain loop's, on the GenEO elasticity pencil.

    python -m dune_eigensolver_tpu_torch.bench.cg_step [--N 512] [--m 8] [--out FILE]

On the card only. The operator is ``elasticity_2d(N)``'s A + 1e-3 B as 2x2
BSR in f32 (n = 2 (N - 1)^2: 522,242 at N = 512), the right-hand sides a
seeded (m, n) block, the apply's rtol 1e-2 and cap 25 steps (the GenEO
cell's). One JSON line a measurement, on stdout and appended to ``--out``:
one apply of each path, in turns: its steps, the device time and the count
of device operations under ``torch.profiler`` (card activity only), the
wall time between two events, and X's largest difference from the plain
loop's over X's largest value. The first line names the card and its power
limit. Each kernel's own time, beside its bounds and its plain version's, is
``chip_smoke.py``'s (phase 22, the kernel table).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


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


def _device_profile(fn):
    """(device seconds, device operations) of one ``fn()`` under the
    profiler, card activity only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time_total for e in ops) * 1e-6, len(ops)


def _wall_s(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--N", type=int, default=512)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cg_step: needs a CUDA device")

    from dune_eigensolver_tpu_torch.factorize import cg as tcg
    from dune_eigensolver_tpu_torch.sparse import problems, spmm_t

    dev = torch.device("cuda")
    _emit(args.out, {"card": _card(), "torch": torch.__version__, "N": args.N, "m": args.m})
    A, Bm = problems.elasticity_2d(args.N, dtype=torch.float32, device=dev)
    A = A.axpy(1e-3, Bm)
    n, m = A.shape[0], args.m
    B = torch.from_numpy(np.random.default_rng(0).standard_normal((m, n))).to(dev, torch.float32)
    d = 1.0 / A.diagonal()

    def apply_fn(fused):
        def run():
            if fused:
                run.out = tcg._cg_fused(lambda V: spmm_t(A, V), B, d, 1e-2, 25)
            else:
                run.out = tcg._cg_loop(lambda V: spmm_t(A, V), B, d, 1e-2, 25, None, None, None)
        return run

    fused, loop = apply_fn(True), apply_fn(False)
    for fn in (fused, loop, fused, loop):  # warm
        fn()
    for name, fn in (("fused", fused), ("plain_loop", loop), ("fused", fused),
                     ("plain_loop", loop)):
        device_s, ops = _device_profile(fn)
        wall_s = _wall_s(fn)
        X_f, X_l = fused.out[0], loop.out[0]
        _emit(args.out, {"apply": name, "m": m, "n": n, "steps": fn.out[1],
                         "device_s": device_s, "device_ops": ops, "wall_s": wall_s,
                         "x_relmax": ((X_f - X_l).abs().max() / X_l.abs().max()).item(),
                         "steps_equal": fused.out[1] == loop.out[1]})


if __name__ == "__main__":
    main()
