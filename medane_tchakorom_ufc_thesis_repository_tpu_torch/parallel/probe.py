"""Communication probes: collective latency and dispatch latency (port of
the JAX package's ``parallel/probe.py``).

The analog of the reference's start-up ping-pong
(``comm_sync_measure_latency_between_two_nodes``,
``src/utils/comm.c:390-424``): chained ring ``ppermute`` rounds along one
mesh axis, timed with CUDA events on a card (the host clock on the CPU).

The events bound the span on the card's stream, not the device work
alone.  On the ``'local'`` transport a round is a few small operations
launched one by one from the host (the shifted copy, the zero fill, the
multiply), and the stream idles between them, so the number is the host's
launch pace more than a device latency.  On ``'dist'`` it also holds the
process-group call and, under gloo, the staging through host memory.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve


def _timed(fn, device: torch.device) -> float:
    """Seconds of ``fn()``: CUDA events on a card, the host clock else."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure_collective_latency(mesh, axis: str = "block",
                               payload_floats: int = 1024,
                               rounds: int = 100) -> Dict[str, float]:
    """Time ``rounds`` chained ring shifts of an f32 payload along ``axis``;
    returns the per-round latency and the effective bandwidth."""
    n = mesh.shape[axis]
    nbytes = payload_floats * 4
    if n < 2:
        return {"per_round_us": 0.0, "gbytes_per_s": float("inf"),
                "rounds": 0, "payload_bytes": nbytes}
    pairs = [(i, (i + 1) % n) for i in range(n)]
    x = torch.ones(mesh.local_shape + (payload_floats,), dtype=torch.float32,
                   device=mesh.device)

    def run():
        v = x
        for _ in range(rounds):
            v = mesh.ppermute(v, axis, pairs) * 1.0000001
        return v

    run()   # warm: groups, buffers
    dt = _timed(run, mesh.device)
    per_round = dt / rounds
    return {"per_round_us": per_round * 1e6,
            "gbytes_per_s": nbytes / per_round / 1e9,
            "rounds": rounds, "payload_bytes": nbytes}


def measure_dispatch_latency(samples: int = 20,
                             device=None) -> Dict[str, float]:
    """One small launch and its read back to the host: the round trip
    every eager operation with a host read pays."""
    dev = resolve(device)
    x = torch.zeros(8, dtype=torch.float32, device=dev)
    (x + 1.0).cpu()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        (x + 1.0).cpu()
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {"median_us": float(np.median(arr) * 1e6),
            "p90_us": float(np.percentile(arr, 90) * 1e6),
            "samples": samples}
