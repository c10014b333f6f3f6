"""Where the port's entry points put what they build.

The port runs on the card.  Every function that takes a ``device``
argument resolves ``device=None`` through ``resolve``: the current CUDA
device, or an error when there is none.  The CPU is never chosen
silently; a caller who wants it (the CPU tests) passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device.  Raises when no card is present: it never
    returns the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            'device="cpu" to run the plain PyTorch versions on the host')
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)
