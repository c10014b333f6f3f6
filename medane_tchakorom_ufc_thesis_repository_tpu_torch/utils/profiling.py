"""Phase profiling: named stages, wall timers and profiler traces (port of
the JAX package's ``utils/profiling.py``).

The analog of the reference's PetscLog stages ("Loading" / "I_Solver" /
"O_Solver" / "Last", fenced with barriers around the solve loop):

* ``PhaseTimer`` -- host-side named wall-clock stages, each fenced on the
  device so that a stage's time holds the work it queued;
* ``trace(logdir)`` -- a ``torch.profiler`` trace written for TensorBoard
  (a no-op when ``logdir`` is None);
* ``annotate(name)`` -- a named range visible in the trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


def fence(x) -> None:
    """Wait until the device has finished the work queued on ``x``'s
    device (``torch.cuda.synchronize``); nothing on the CPU."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class PhaseTimer:
    """Accumulating named-stage wall timers.

    >>> pt = PhaseTimer()
    >>> with pt.phase("I_Solver", fence_on=x):
    ...     x = step(x)
    >>> pt.report()
    """

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str, fence_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence_on is not None:
                fence(fence_on)
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._acc[name] = 0.0
                self._counts[name] = 0
                self._order.append(name)
            self._acc[name] += dt
            self._counts[name] += 1

    def items(self) -> List[Tuple[str, float, int]]:
        return [(k, self._acc[k], self._counts[k]) for k in self._order]

    def report(self, printer=print) -> None:
        total = sum(self._acc.values()) or 1.0
        printer(f"{'stage':<16s} {'time_s':>10s} {'calls':>7s} {'share':>7s}")
        for name, t, c in self.items():
            printer(f"{name:<16s} {t:>10.4f} {c:>7d} {t / total:>6.1%}")


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card, written to ``logdir`` for TensorBoard (no-op when None)."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """A named range visible in profiler traces."""
    return torch.profiler.record_function(name)
