"""The program's own spans and counters, read after the window by the
traced run's readers ``cg.steps``, ``solver.wait_pct``, ``cg.idle_pct``,
``ortho.device_pct`` and ``rr.device_pct``.

The spans are the program's (``dune_eigensolver_tpu_torch/utils/vlog.py``:
``solve``, ``lobpcg.*``, ``cg.apply``, ``cg.stop``), stamped with
``time.time_ns()``, which is the clock of ``torch.profiler``'s Chrome trace
(``baseTimeNanoseconds`` + ``ts`` * 1000). The counters are
``cg_solve_t.calls`` and ``cg_solve_t.steps``.

By the time the readers run, the harness has released the program's state,
and its profiled solves have left the profiler's hooks in the process: the
host runs a solve 1.5-1.9 times slower after a profile than before one. So
``measure`` runs a process of its own (``python3 -m
solvebench.program_trace``) that sets the cell up once more (``run.Cell``,
its warm solve with the spans off), runs ``SOLVES`` solves from the pool's
first start with the spans on and no profiler (the host's own pace:
``solver.wait_pct``), then one more with the spans on, profiled with the
card's activity alone (``cg.idle_pct`` and the phases' device shares), and
hands the spans and the device operations back in a file. It measures on
the device the run measured (``device_of``) and refuses to start on a card
it cannot see. It runs once a run; the result is kept on the run. A program without the spans
(``vlog.tracing``) or a run without solves reads nothing, and nothing is
started.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

from solvebench.trace import DEVICE_CATS, LAUNCH_CATS

#: unprofiled solves with the spans on
SOLVES = 4
#: the spans in which the host waits for the card
STOP_SPANS = ("cg.stop", "lobpcg.stop")
#: seconds the measuring process may take
TIMEOUT_S = 600
_KEY = "program_trace"
_CHECKOUT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Op:
    """A device operation on the trace's clock (microseconds from its
    base): its start, length and the start of the host call that launched
    it (None where the trace has no launch record for it)."""

    start: float
    dur: float
    launch: Optional[float]


@dataclasses.dataclass
class Measured:
    spans: list  # span records of the SOLVES unprofiled solves
    profiled: list  # span records of the profiled solve
    base_ns: int  # the profile's baseTimeNanoseconds
    ops: List[Op]


def _vlog():
    return importlib.import_module("dune_eigensolver_tpu_torch.utils.vlog")


def available() -> bool:
    """Whether the program has the spans: ``vlog.tracing``."""
    try:
        return hasattr(_vlog(), "tracing")
    except ImportError:
        return False


def cg_counts() -> Optional[tuple]:
    """(calls, steps) of the program's ``cg_solve_t`` now, or None where the
    program does not count them."""
    cg = importlib.import_module("dune_eigensolver_tpu_torch.factorize.cg").cg_solve_t
    if not (hasattr(cg, "calls") and hasattr(cg, "steps")):
        return None
    return int(cg.calls), int(cg.steps)


def steps_per_apply() -> Optional[float]:
    """CG steps per preconditioner apply over every solve of this process:
    the run's (``measure``'s are another process's)."""
    counts = cg_counts()
    if counts is None or counts[0] == 0:
        return None
    return counts[1] / counts[0]


def device_of(run) -> str:
    """The device ``run`` measured: the card where its window's peak was read
    from the card's allocator (``run.Card.peak`` reads 0 on the CPU)."""
    return "cuda" if run.peak_bytes > 0 else "cpu"


def measure(run, root: Path) -> Optional[Measured]:
    """The spans of ``SOLVES`` unprofiled solves and of one profiled solve
    of ``run``'s cell, set up again from ``root`` in a process of its own
    (once a run)."""
    if _KEY in run.__dict__:
        return run.__dict__[_KEY]
    run.__dict__[_KEY] = None
    if not run.solve_times or not available():
        return None
    from solvebench.run import log

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="solvebench_spans_") as tmp:
        out = Path(tmp) / "spans.json"
        subprocess.run([sys.executable, "-m", "solvebench.program_trace", "--workload", run.cell,
                        "--root", str(root), "--out", str(out), "--device", device_of(run)],
                       cwd=_CHECKOUT, check=True, stdout=sys.stderr, timeout=TIMEOUT_S)
        with open(out) as fh:
            got = json.load(fh)
    spans = [SimpleNamespace(**s) for s in got["spans"]]
    profiled = [SimpleNamespace(**s) for s in got["profiled"]]
    ops = [Op(*op) for op in got["ops"]]
    log(f"program spans: {time.perf_counter() - t0:.3f} s in their process")
    run.__dict__[_KEY] = Measured(spans, profiled, int(got["base_ns"]), ops)
    return run.__dict__[_KEY]


def main(argv=None) -> int:
    """The measuring process: set the cell up, solve with the spans on,
    profile one more, write the spans and the device operations."""
    ap = argparse.ArgumentParser(prog="python3 -m solvebench.program_trace")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--root", required=True, help="the benchmark's folder")
    ap.add_argument("--out", required=True, help="the JSON file to write")
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"),
                    help="the device the run measured")
    args = ap.parse_args(argv)
    import torch

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("solvebench.program_trace: the run measured the card, and this "
                           "process sees none")

    from solvebench import trace as tr
    from solvebench.run import Cell, log

    torch.set_num_threads(1)
    vlog = _vlog()
    t0 = time.perf_counter()
    cell = Cell(args.workload, 0, device=args.device, root=Path(args.root))
    try:
        start = next(cell.starts(0, shuffle=False))
        t1 = time.perf_counter()
        with vlog.tracing() as spans:
            for _ in range(SOLVES):
                cell.solve(start).eigenvalues.cpu()
        t2 = time.perf_counter()
        tr.warm_profiler(torch)
        with vlog.tracing() as profiled:
            base_ns, ops = profile(torch, lambda: cell.solve(start), cuda)
    finally:
        cell.release()
    log(f"program spans on {args.device}: set up {t1 - t0:.3f} s, {SOLVES} solves {t2 - t1:.3f} s "
        f"({len(spans)} spans), profiled {time.perf_counter() - t2:.3f} s ({len(ops)} device "
        f"operations, {sum(op.launch is not None for op in ops)} linked)")
    fields = ("name", "start_ns", "end_ns", "parent")
    with open(args.out, "w") as fh:
        json.dump({"spans": [{f: getattr(s, f) for f in fields} for s in spans],
                   "profiled": [{f: getattr(s, f) for f in fields} for s in profiled],
                   "base_ns": base_ns,
                   "ops": [[op.start, op.dur, op.launch] for op in ops]}, fh)
    return 0


def profile(torch, solve, cuda: bool):
    """One call of ``solve`` read back to the host under ``torch.profiler``
    with the card's activity alone (``cuda``), else the host's alone:
    (baseTimeNanoseconds, its device operations)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with torch_profile(activities=[activity]) as prof:
        solve().eigenvalues.cpu()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="solvebench_spans_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.remove(path)
    return int(trace.get("baseTimeNanoseconds", 0)), device_ops(trace["traceEvents"])


def device_ops(events) -> List[Op]:
    """The device operations of a Chrome trace's events, each with the
    start of its earliest launch record where the trace has one (by
    correlation id)."""
    launches = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            t = float(e["ts"])
            launches[corr] = min(t, launches.get(corr, t))
    return [Op(float(e["ts"]), float(e.get("dur", 0.0)),
               launches.get(e.get("args", {}).get("correlation")))
            for e in events if e.get("cat") in DEVICE_CATS]


def _seconds_in(spans, names) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e9


def wait_pct(spans) -> Optional[float]:
    """Seconds inside the stop reads over the seconds inside ``solve``."""
    total = _seconds_in(spans, ("solve",))
    return 100.0 * _seconds_in(spans, STOP_SPANS) / total if total > 0 else None


def _intervals(spans, name, base_ns):
    """The spans named ``name`` as (start, end) on the trace's clock, in
    order; they do not overlap one another."""
    return sorted(((s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3)
                  for s in spans if s.name == name)


def idle_gaps(ops) -> list:
    """The stretches between the union of the operations' intervals."""
    gaps, end = [], None
    for op in sorted(ops, key=lambda o: o.start):
        if end is not None and op.start > end:
            gaps.append((end, op.start))
        end = op.start + op.dur if end is None else max(end, op.start + op.dur)
    return gaps


def idle_pct_inside(ops, spans, base_ns, name) -> Optional[float]:
    """The share of the operations' idle seconds that fall inside a span
    named ``name``."""
    gaps = idle_gaps(ops)
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    inside = _intervals(spans, name, base_ns)
    starts = [a for a, _ in inside]
    covered = 0.0
    for a, b in gaps:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(inside) and inside[i][0] < b:
            covered += max(0.0, min(b, inside[i][1]) - max(a, inside[i][0]))
            i += 1
    return 100.0 * covered / total


def innermost(spans, base_ns):
    """A function of a time on the trace's clock: the index in ``spans``
    of the innermost span open then, or None. ``spans`` are in the order
    they opened, each with its parent's index."""
    starts = [(s.start_ns - base_ns) / 1e3 for s in spans]
    ends = [(s.end_ns - base_ns) / 1e3 for s in spans]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        while i is not None and i >= 0 and ends[i] < t:
            i = spans[i].parent
        return None if i is None or i < 0 else i

    return at


def device_pct_under(ops, spans, base_ns, name) -> Optional[float]:
    """Device seconds of the operations launched inside a span named
    ``name`` (the innermost span open at the launch, or one around it) over
    the device seconds of all of them. None without launch records."""
    total = sum(op.dur for op in ops)
    if total <= 0 or not any(op.launch is not None for op in ops):
        return None
    at = innermost(spans, base_ns)
    under = 0.0
    for op in ops:
        i = None if op.launch is None else at(op.launch)
        while i is not None and spans[i].name != name:
            i = spans[i].parent
        if i is not None:
            under += op.dur
    return 100.0 * under / total


if __name__ == "__main__":
    raise SystemExit(main())
