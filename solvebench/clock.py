"""The process's start on the ``time.perf_counter`` clock."""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """``perf_counter()`` at the moment the kernel started this process, so
    that ``setup_s`` includes the interpreter's own start. Read from
    ``/proc`` (10 ms ticks); where that is missing, now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)
