"""One profiled solve, read from ``torch.profiler``'s trace.

The profiler's Chrome trace is written to a temporary file, read and
deleted. Each device operation (a kernel, a copy or a fill on the card) is
kept with its start and length and, where the trace links it to the host
call that launched it (its correlation id), the stack of host ranges open at
that launch: the program's aten operations and the harness's own ranges
(``spans.py``). The busy share counts the union of the operations'
intervals; the idle gaps are the stretches between them, named by what the
host was launching when the card went on.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # microseconds, the trace's clock
    dur: float
    stack: Optional[Tuple[str, ...]]  # host ranges open at its launch, outermost first


@dataclasses.dataclass
class Profile:
    wall_s: float
    ops: List[DeviceOp]

    @property
    def count(self) -> int:
        return len(self.ops)

    @property
    def linked(self) -> int:
        return sum(op.stack is not None for op in self.ops)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        total, end = 0.0, float("-inf")
        for op in sorted(self.ops, key=lambda o: o.start):
            lo, hi = max(op.start, end), op.start + op.dur
            if hi > lo:
                total += hi - lo
            end = max(end, hi)
        return total / 1e6

    def device_s(self, match=None) -> float:
        """Summed device seconds of the operations ``match(op)`` selects."""
        return sum(op.dur for op in self.ops if match is None or match(op)) / 1e6

    def under(self, prefix: str) -> float:
        """Device seconds of the operations launched inside a host range
        whose name starts with ``prefix``."""
        return self.device_s(lambda op: op.stack is not None
                             and any(s.startswith(prefix) for s in op.stack))

    def by_name(self, width: int = 120) -> list:
        """[[name, seconds], ...], the most device time first."""
        acc = collections.Counter()
        for op in self.ops:
            acc[op.name[:width]] += op.dur / 1e6
        return [[k, v] for k, v in acc.most_common()]

    def idle_gaps(self) -> list:
        """[[what the host launched next, idle seconds], ...]: every stretch
        in which no operation ran, summed by the host call whose device
        operation ended it, the longest total first."""
        acc = collections.Counter()
        end = None
        for op in sorted(self.ops, key=lambda o: o.start):
            if end is not None and op.start > end:
                acc[_launcher(op)] += (op.start - end) / 1e6
            end = op.start + op.dur if end is None else max(end, op.start + op.dur)
        return [[k, v] for k, v in acc.most_common()]


def _launcher(op: DeviceOp) -> str:
    if op.stack is None:
        return f"unlinked launch of {op.name[:60]}"
    mine = [s for s in op.stack if s.startswith("solvebench.precond.")]
    where = mine[0] if mine else "solver"
    inner = [s for s in op.stack if not s.startswith("solvebench.launch.")]
    return f"{where} / {inner[-1] if inner else op.name[:60]}"


def _stacks(host, queries):
    """For each (time, tid) query, the names of the host ranges on that
    thread that contain the time, outermost first (ranges nest per thread)."""
    out = [None] * len(queries)
    by_tid = collections.defaultdict(list)
    for r in host:
        by_tid[r[3]].append(r)
    want = collections.defaultdict(list)
    for qi, (t, tid) in enumerate(queries):
        want[tid].append((t, qi))
    for tid, qs in want.items():
        ranges = sorted(by_tid.get(tid, ()), key=lambda r: (r[0], -r[1]))
        stack, ri = [], 0
        for t, qi in sorted(qs):
            while ri < len(ranges) and ranges[ri][0] <= t:
                r = ranges[ri]
                while stack and stack[-1][1] <= r[0]:
                    stack.pop()
                stack.append(r)
                ri += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[qi] = tuple(r[2] for r in stack)
    return out


def parse(events) -> List[DeviceOp]:
    """The device operations of a Chrome trace's events, with their host
    stacks where the trace links them to a launch."""
    launches, host, device = {}, [], []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat in HOST_CATS and e.get("ph") == "X":
            ts = float(e["ts"])
            host.append((ts, ts + float(e.get("dur", 0.0)), e["name"], e.get("tid")))
    found = [launches.get(e.get("args", {}).get("correlation")) for e in device]
    stacks = _stacks(host, [q for q in found if q is not None])
    it = iter(stacks)
    return [DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                     next(it) if q is not None else None)
            for e, q in zip(device, found)]


def warm_profiler(torch) -> None:
    """Start and stop the profiler once on a trivial operation, so that the
    first profiled solve does not pay the tracer's own start (seconds)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=acts):
        torch.ones(8).sum().item()


def profile_solve(torch, run, cpu: bool) -> Profile:
    """One call of ``run`` (a solve read back to the host) under
    ``torch.profiler``: the card's activity, and with ``cpu`` the host's
    operations and ranges too (which slows the host several times over).
    Without a card (the harness's own tests) the host's alone."""
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if card else []
    if cpu or not card:
        acts.append(ProfilerActivity.CPU)
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run().eigenvalues.cpu()
    wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="solvebench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return Profile(wall_s=wall, ops=parse(events))
