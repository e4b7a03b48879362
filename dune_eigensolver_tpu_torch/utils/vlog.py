"""Verbosity-tiered logging, wall-clock spans, the program's trace spans and
a profiler trace.

Counterpart of the JAX package's ``utils/vlog.py``. The reference threads an
integer ``verbose`` through every API (0 = silent, 1 = results, 2 =
per-iteration, 3+ = debug) and times spans with ``Dune::Timer``; the same
contract here. ``profiler_trace`` wraps a region in ``torch.profiler``
(the JAX package's ``jax.profiler`` trace) and writes a Chrome trace.

The program's trace spans (``span``) mark its phases where
the work happens: ``solve`` (one entry-point call), ``lobpcg.setup``,
``lobpcg.spmm``, ``lobpcg.precond``, ``lobpcg.ortho``, ``lobpcg.rr``,
``lobpcg.stop``, ``cg.apply`` and ``cg.stop``. They are off unless a caller
holds ``tracing()`` (or ``profiler_trace``): off, a span is one test of a
module flag and adds no device operation, no sync and no clock read. On,
each span appends a ``Span`` record to the list ``tracing()`` yields and,
while a ``torch.profiler`` runs, opens a ``record_function`` range of the
same name; its start and end are read from ``time.time_ns()``, which is
the clock of ``torch.profiler``'s Chrome trace (``baseTimeNanoseconds`` +
``ts`` * 1000), before the range opens and after it closes, so the span
holds its range.
The holder of the list writes it out; nothing is written while the spans
run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Optional

import torch


def warn_fallback(msg: str) -> None:
    """Loud, greppable degradation warning on stderr, whatever the
    verbosity: an engine took a slower (or semantically weaker) path than
    the one the caller asked for. Grep for ``FALLBACK:``."""
    print(f"FALLBACK: {msg}", file=sys.stderr, flush=True)


class VLog:
    """print-through logger gated on an integer verbosity level."""

    def __init__(self, verbose: int = 0, prefix: str = ""):
        self.verbose = int(verbose)
        self.prefix = prefix

    def __call__(self, level: int, *msg):
        if self.verbose >= level:
            if self.prefix:
                print(self.prefix, *msg, flush=True)
            else:
                print(*msg, flush=True)

    @contextlib.contextmanager
    def span(self, name: str, level: int = 1):
        """Timed span: logs '<name>: <seconds>s' at the given level (the
        Dune::Timer idiom)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self(level, f"{name}: {time.perf_counter() - t0:.4f}s")


@dataclasses.dataclass
class Span:
    """One span's record: ``start_ns``/``end_ns`` on ``time.time_ns()``'s
    clock, ``parent`` the index in the same list of the span that was open
    around it (None at the top). The root of a span's parent chain is the
    ``solve`` it ran in."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    attrs: dict


_OFF = contextlib.nullcontext()
_records: Optional[list] = None  # the list of the open ``tracing()``; None: spans off
_open: list = []  # indices of the spans open now, innermost last


class _On:
    """A span while tracing is on (``span``)."""

    __slots__ = ("name", "attrs", "index", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        rec = Span(self.name, time.time_ns(), None, _open[-1] if _open else None, self.attrs)
        # a range only where a profiler records it: without one it costs
        # ~10 us and records nothing
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.index = len(_records)
        _records.append(rec)
        _open.append(self.index)
        return rec

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        _records[self.index].end_ns = time.time_ns()
        _open.pop()
        return False


def span(name: str, **attrs):
    """A context manager that records the block as a span named ``name``
    with ``attrs`` while tracing is on; off, a shared no-op context."""
    if _records is None:
        return _OFF
    return _On(name, attrs)


@contextlib.contextmanager
def tracing():
    """Switch the spans on for the block and yield the list of their
    ``Span`` records, in the order they opened. Inside an open
    ``tracing()`` the block appends to the same list."""
    global _records
    if _records is not None:
        yield _records
        return
    _records = []
    try:
        yield _records
    finally:
        _records = None
        _open.clear()


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """``torch.profiler`` over the block, with the card's activity when torch
    sees one, and the program's spans on (``tracing``), so the trace shows
    its phases as ranges; on exit the trace is written into ``logdir`` as
    ``trace_<pid>_<ns>.json`` (Chrome trace format: chrome://tracing,
    Perfetto). A falsy ``logdir`` is a no-op."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        with tracing():
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
