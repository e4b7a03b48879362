"""``peak_gb`` (GB, end to end): ``torch.cuda.max_memory_allocated()`` over
the window, after a reset at its start, in units of 1e9 bytes."""

UNIT = "GB"


def read(run):
    return run.peak_bytes / 1e9
