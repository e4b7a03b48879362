"""Verbosity-tiered logging, wall-clock spans and a profiler trace.

Counterpart of the JAX package's ``utils/vlog.py``. The reference threads an
integer ``verbose`` through every API (0 = silent, 1 = results, 2 =
per-iteration, 3+ = debug) and times spans with ``Dune::Timer``; the same
contract here. ``profiler_trace`` wraps a region in ``torch.profiler``
(the JAX package's ``jax.profiler`` trace) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional


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


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """``torch.profiler`` over the block, with the card's activity when torch
    sees one; on exit the trace is written into ``logdir`` as
    ``trace_<pid>_<ns>.json`` (Chrome trace format: chrome://tracing,
    Perfetto). A falsy ``logdir`` is a no-op."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
