"""The port's device default: the card, never the CPU on its own.

Every problem generator, bridge and entry point that takes ``device=None`` goes
through ``resolve``: ``None`` means the current CUDA device, and a machine
on which torch sees no card raises instead of quietly building on the CPU.
A caller that wants the CPU (the CPU tests do) says ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` (or an empty string, the
    CLI's ``ev.device`` default) is the current CUDA device. Raises
    ``RuntimeError`` when the default is asked for and torch sees no card."""
    if device is None or device == "":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torch.cuda.is_available() is false. The port "
                "runs on the card by default; pass device='cpu' (ev.device=cpu "
                "on the command line) to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
