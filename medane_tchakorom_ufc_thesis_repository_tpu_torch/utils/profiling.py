"""Phase profiling: named stages, wall timers, spans and profiler traces
(port of the JAX package's ``utils/profiling.py``).

The analog of the reference's PetscLog stages ("Loading" / "I_Solver" /
"O_Solver" / "Last", fenced with barriers around the solve loop):

* ``PhaseTimer`` -- host-side named wall-clock stages, each fenced on the
  device so that a stage's time holds the work it queued;
* ``span(name, device)`` -- an unfenced span at a place where the
  program does its work, recorded only while ``recording()`` is entered
  or a ``torch.profiler`` session records; ``totals()`` sums them by name;
* ``trace(logdir)`` -- a ``torch.profiler`` trace written for TensorBoard
  (a no-op when ``logdir`` is None).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


def fence(x) -> None:
    """Wait until the device has finished the work queued on ``x``'s
    device (``torch.cuda.synchronize``); nothing on the CPU."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class PhaseTimer:
    """Accumulating named-stage wall timers; each phase is also a span of
    its name.

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
            with span(name):
                try:
                    yield
                finally:
                    if fence_on is not None:
                        fence(fence_on)
        finally:
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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

_OFF = contextlib.nullcontext()   # the one context every span gives when off
_PENDING_CAP = 4096               # device pairs held before the oldest fold


class _Recorder:
    """Per-name totals of the spans: calls and host nanoseconds as each
    span ends; device milliseconds from pairs of CUDA events, folded when
    the totals are read or once ``_PENDING_CAP`` pairs wait."""

    def __init__(self):
        self.entered = 0                      # ``recording()`` depth
        self.calls: Dict[str, int] = {}
        self.host_ns: Dict[str, int] = {}
        self.device_ms: Dict[str, float] = {}
        self.pending: List[Tuple[str, object, object]] = []

    def fold(self, upto: int) -> None:
        """Add the first ``upto`` pending pairs to the device totals.  A
        pair the card has not reached yet stops the fold (never waits)."""
        done = 0
        for name, start, end in self.pending[:upto]:
            try:
                ms = start.elapsed_time(end)
            except RuntimeError:              # not reached: fold it later
                break
            self.device_ms[name] = self.device_ms.get(name, 0.0) + ms
            done += 1
        del self.pending[:done]


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "stream", "start", "range", "t0")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = None
        if isinstance(device, torch.Tensor) and device.is_cuda \
                and not torch.cuda.is_current_stream_capturing():
            self.stream = torch.cuda.current_stream(device.device)

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            # function scope: a host range the profiler does not mirror
            # onto the device's timeline as a user annotation
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        name = self.name
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _REC.pending.append((name, self.start, end))
            if len(_REC.pending) >= _PENDING_CAP:
                _REC.fold(_PENDING_CAP // 2)
        _REC.calls[name] = _REC.calls.get(name, 0) + 1
        _REC.host_ns[name] = _REC.host_ns.get(name, 0) + dt
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


def span(name: str, device: Optional[torch.Tensor] = None):
    """A span named ``name`` around a stage of the program.

    Off (no ``recording()`` entered, no profiler recording) it is one
    shared do-nothing context.  On, it adds its call and host seconds to
    ``totals()``, opens a host range of that name on the profiler's
    timeline when a profiler records, and, when ``device`` is a tensor on
    a card, times the span on the device too: a CUDA event on that
    device's current stream before and after (none inside a graph
    capture).  A span never waits for the device."""
    if not (_REC.entered or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


@contextlib.contextmanager
def recording():
    """Record spans inside this block even with no profiler running."""
    _REC.entered += 1
    try:
        yield
    finally:
        _REC.entered -= 1


def totals() -> Dict[str, Tuple[int, float, float]]:
    """``{name: (calls, host seconds, device seconds)}`` of every span
    recorded since the last ``reset()``; device seconds are 0 for a span
    with no device timing.  Read after the card has run the spans' work
    (each solve ends in a read of its result): a pair of events the card
    has not reached yet is waited for."""
    for _, _, end in _REC.pending:
        end.synchronize()
    _REC.fold(len(_REC.pending))
    return {name: (calls, _REC.host_ns[name] * 1e-9,
                   _REC.device_ms.get(name, 0.0) * 1e-3)
            for name, calls in _REC.calls.items()}


def reset() -> None:
    """Clear the totals and drop the pending device pairs."""
    for held in (_REC.calls, _REC.host_ns, _REC.device_ms, _REC.pending):
        held.clear()
