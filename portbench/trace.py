"""What the traced run reads: the port's kernel launches with their byte
counts, and the profiler's device events reduced to per-solve figures.

``LaunchShim`` wraps each kernel wrapper that has a count file
(``portbench/kernels/*.py``) wherever the port binds it, and the port's
``CountedGraph``: a launch made while a graph is captured is kept with
that graph and counted again at every replay, as ``CountedGraph`` keeps
its launch counts.  ``reduce`` turns the profiler's events into device
time by kernel inside the solves' ranges, the union of the device's busy
intervals, and the idle gaps with what the host was doing in them.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import inspect
import re
import sys
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PORT = "medane_tchakorom_ufc_thesis_repository_tpu_torch"
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet, at 700 W
RANGE = "portbench.solve"  # the record_function range around each solve

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def symbol_of(name: str) -> str:
    """The function name of a device kernel as the profiler shows it:
    ``void (anonymous namespace)::stack_kernel<float, 2>(float const*, ...)``
    -> ``stack_kernel``."""
    m = re.match(r"\s*(?:void\s+)?([\w:]+)",
                 name.replace("(anonymous namespace)::", ""))
    return m.group(1).split("::")[-1] if m else name


def port_symbols(port_dir: Path) -> set:
    """Every ``__global__`` function name in the port's ``csrc/``."""
    found = set()
    for path in sorted((Path(port_dir) / "csrc").glob("*.cu*")):
        found.update(_GLOBAL.findall(path.read_text()))
    return found


# ---------------------------------------------------------------------------
# Launches and their bytes
# ---------------------------------------------------------------------------

def _shape_key(p: dict) -> str:
    for v in p.values():
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
    return "?"


class LaunchShim:
    """Records ``(label, bytes, shape)`` for every launch of a wrapper that
    has a count file, while ``tracing`` is set or a graph is captured."""

    def __init__(self, kernel_files: Dict[str, object]):
        self.files = kernel_files
        self.records: List[Tuple[str, int, str]] = []
        self.tracing = False
        self._capturing: Optional[list] = None
        self._graphs: Dict[int, Tuple[object, list]] = {}
        self._depth = 0
        self._saved: List[Tuple[object, str, object]] = []

    def _wrap(self, fn, kf):
        sig = inspect.signature(fn)
        var = [n for n, q in sig.parameters.items()
               if q.kind is inspect.Parameter.VAR_POSITIONAL]

        def wrapped(*args, **kwargs):
            if self._depth:                  # a wrapper inside a wrapper
                return fn(*args, **kwargs)
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            sink = self._capturing if self._capturing is not None else (
                self.records if self.tracing else None)
            if sink is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                p = dict(bound.arguments)
                for name in var:
                    p["extras"] = p.pop(name)
                label, n = kf.launch(p)
                sink.append((label, int(n), _shape_key(p)))
            return out

        return wrapped

    def install(self) -> None:
        """Wrap every counted wrapper in each loaded module of the port
        that binds it, and ``CountedGraph``'s capture and replay."""
        for kf in self.files.values():
            fn = getattr(importlib.import_module(kf.MODULE), kf.FUNCTION)
            wrapped = self._wrap(fn, kf)
            for name, mod in list(sys.modules.items()):
                if mod is None or name.split(".")[0] != PORT:
                    continue
                for attr, value in list(vars(mod).items()):
                    if value is fn:
                        self._saved.append((mod, attr, value))
                        setattr(mod, attr, wrapped)
        build = importlib.import_module(f"{PORT}.ops.build")
        cls = build.CountedGraph
        capture, replay = cls.capture, cls.replay
        shim = self

        def counted_capture(graph, fn):
            outer, shim._capturing = shim._capturing, []
            try:
                out = capture(graph, fn)
                shim._graphs[id(graph)] = (graph, shim._capturing)
            finally:
                shim._capturing = outer
            return out

        def counted_replay(graph):
            replay(graph)
            if shim.tracing:
                shim.records.extend(shim._graphs.get(id(graph), (None, []))[1])

        self._saved += [(cls, "capture", capture), (cls, "replay", replay)]
        cls.capture, cls.replay = counted_capture, counted_replay

    def uninstall(self) -> None:
        for owner, attr, value in reversed(self._saved):
            setattr(owner, attr, value)
        self._saved.clear()


# ---------------------------------------------------------------------------
# The profiler's events
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Events:
    """Intervals in microseconds on the profiler's clock."""
    device: List[Tuple[str, float, float]]   # kernels, copies, sets
    host: List[Tuple[str, float, float]]     # CPU ops and runtime calls
    ranges: List[Tuple[float, float]]        # the solves' ranges


def _raw_events(prof):
    """``(name, start_us, end_us, on_device)`` of every event the profiler
    kept.  Read from its Kineto results, which skips building the
    ``FunctionEvent`` tree: on a solve of 150,000 launches that tree takes
    minutes."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        for e in prof.events():
            yield (e.name, float(e.time_range.start), float(e.time_range.end),
                   str(e.device_type).endswith("CUDA"))
        return
    for e in results.events():
        yield (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
               str(e.device_type()).endswith("CUDA"))


def events_of(prof) -> Events:
    """Device and host intervals and the solves' ranges from a finished
    ``torch.profiler.profile``."""
    device, host, ranges = [], [], []
    for name, s, t, on_device in _raw_events(prof):
        if on_device:
            if not name.startswith("portbench."):   # GPU user annotations
                device.append((name, s, t))
        elif name == RANGE:
            ranges.append((s, t))
        elif not name.startswith("portbench."):
            host.append((name, s, t))
    return Events(device, host, sorted(ranges))


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


@dataclasses.dataclass
class Reduced:
    window_s: float                    # the solves' ranges, summed
    busy_s: float                      # union of device intervals in them
    by_name: Dict[str, float]          # device seconds by event name
    gaps: List[Tuple[str, float]]      # (host op, idle seconds) per gap


def reduce(ev: Events) -> Reduced:
    """Device time by name, busy union and idle gaps inside the ranges.
    A device event belongs to the range in which it starts; busy time is
    clipped to the range."""
    starts = [r[0] for r in ev.ranges]
    inside: Dict[int, list] = defaultdict(list)
    by_name: Dict[str, float] = Counter()
    for name, s, t in ev.device:
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or s >= ev.ranges[i][1]:
            continue
        inside[i].append((s, t))
        by_name[name] += (t - s) * 1e-6
    window = busy = 0.0
    gap_list: List[Tuple[float, float]] = []
    for i, (rs, re_) in enumerate(ev.ranges):
        window += re_ - rs
        cursor = rs
        for s, t in merge((max(s, rs), min(t, re_)) for s, t in inside[i]):
            busy += t - s
            if s > cursor:
                gap_list.append((cursor, s))
            cursor = max(cursor, t)
        if re_ > cursor:
            gap_list.append((cursor, re_))
    return Reduced(window * 1e-6, busy * 1e-6, dict(by_name),
                   host_at_gaps(ev.host, gap_list))


def host_at_gaps(host: Sequence[Tuple[str, float, float]],
                 gaps: Sequence[Tuple[float, float]]) -> List[Tuple[str, float]]:
    """``(name, seconds)`` for each gap: the innermost host op (the latest
    started one still running) at the gap's midpoint, or ``host (no op)``."""
    ops = sorted(host, key=lambda o: (o[1], -o[2]))
    order = sorted(range(len(gaps)), key=lambda g: gaps[g][0] + gaps[g][1])
    out: List[Optional[Tuple[str, float]]] = [None] * len(gaps)
    stack: List[Tuple[str, float, float]] = []
    j = 0
    for g in order:
        s, t = gaps[g]
        mid = 0.5 * (s + t)
        while j < len(ops) and ops[j][1] <= mid:
            while stack and stack[-1][2] < ops[j][1]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out[g] = (stack[-1][0] if stack else "host (no op)", (t - s) * 1e-6)
    return out


def top(pairs: Iterable[Tuple[str, float]], n: int = 10,
        width: int = 120) -> List[list]:
    """The ``n`` largest totals by name, names cut to ``width``."""
    total: Dict[str, float] = Counter()
    for name, sec in pairs:
        total[name[:width]] += sec
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def split_device_time(by_name: Dict[str, float], port: set) -> Tuple[float, float]:
    """``(seconds in the port's own kernels, seconds in everything else)``."""
    own = sum(v for k, v in by_name.items() if symbol_of(k) in port)
    return own, sum(by_name.values()) - own


def roofline(launch_bytes: float, by_name: Dict[str, float],
             counted: set) -> Optional[float]:
    """Percent of the bytes bound: the launches' bytes over the peak rate,
    over the device time of the kernels whose wrappers count their bytes.
    None when those kernels took no device time."""
    t = sum(v for k, v in by_name.items() if symbol_of(k) in counted)
    if t <= 0:
        return None
    return 100.0 * (launch_bytes / PEAK_BYTES_S) / t


# ---------------------------------------------------------------------------
# The device metrics' readers (``portbench/metrics``), over the traced solves
# ---------------------------------------------------------------------------

def own_device_ms(ctx) -> Optional[float]:
    """Device ms a solve in the port's own kernels."""
    if ctx.reduced is None:
        return None
    own, _ = split_device_time(ctx.reduced.by_name, ctx.own)
    return 1e3 * own / ctx.solves if own > 0 else None


def other_device_ms(ctx) -> Optional[float]:
    """Device ms a solve in everything else: PyTorch's kernels, cuBLAS,
    cuSOLVER, copies and sets."""
    if ctx.reduced is None:
        return None
    _, other = split_device_time(ctx.reduced.by_name, ctx.own)
    return 1e3 * other / ctx.solves


def roofline_pct(ctx) -> Optional[float]:
    if ctx.reduced is None:
        return None
    return roofline(ctx.launch_bytes, ctx.reduced.by_name, ctx.counted)


def idle_pct(ctx) -> Optional[float]:
    r = ctx.reduced
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
