"""Solver-state checkpoints (port of the JAX package's
``utils/checkpoint.py``, in the same file format, so that a checkpoint
written by either package loads in the other).

Multisplitting state is small (the iterate ``x`` plus counters), so one
``.npz`` holds it: ``x`` and the JSON metadata as a byte array.  Every
solver takes ``x0`` for a warm restart, so resuming is a load and an
``x0``:

>>> save_state("ckpt.npz", res.x, sweeps=res.sweeps)
>>> x0, meta = load_state("ckpt.npz")
>>> res2 = sm(op, b, x0=torch.from_numpy(x0).to(b.device), ...)
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch


def save_state(path: str, x, **meta) -> None:
    """Write the iterate (a tensor on any device, or an array; copied to
    the host) and JSON-serializable metadata to ``path``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    np.savez(
        path,
        x=np.asarray(x),
        meta=np.frombuffer(
            json.dumps(meta, default=float).encode(), dtype=np.uint8
        ),
    )


def load_state(path: str) -> Tuple[np.ndarray, Dict]:
    """``(x, meta)`` from a checkpoint written by ``save_state``; ``x`` is
    a host array for the caller to place."""
    with np.load(path) as z:
        x = z["x"]
        meta = (json.loads(bytes(z["meta"].tobytes()).decode())
                if "meta" in z else {})
    return x, meta
