"""One run of one cell: set-up, the window (or the traced solves), the
check against the plain reference, and the result line.

The window is a closed loop with one caller, as a time-stepping code that
solves one system a step: solve ``k`` starts when its right-hand side (the
pool member that ``(seed, k)`` picks, ``rhs.member``) is made on the
device and ends at a synchronised result; the next starts then.  The
window closes at the end of the first pass through the pool that ends
after ``--seconds``.  A seed-drawn sample of the solves (always the first
among them) has its answer copied to the host on a side stream while the
next solve runs; the reference judges those answers once the window has
closed, the peak memory has been read and the program's state has been
freed.
"""

from __future__ import annotations

import gc
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import registry, rhs, trace
from portbench.reference.stencil import relative_residual

FORBIDDEN = ("jax", "jaxlib", "flax", "medane_tchakorom_ufc_thesis_repository_tpu")
SMI_QUERY = ("name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,power.draw,"
             "temperature.gpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the port's runs must not
    load, compared whole: the port's own name begins with the JAX
    package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_reading() -> str:
    """``nvidia-smi``'s name, power limit, clocks, draw and temperature."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi not read ({err})"
    return (out.stdout.strip() or out.stderr.strip()).replace("\n", " | ")


def sample(seed: int, pool: int, size: int) -> List[int]:
    """The solves whose answers are judged: solve 0 and ``size - 1`` more
    drawn from ``1 .. pool - 1`` by the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 2]))
    rest = rng.choice(np.arange(1, max(pool, 1)),
                      size=max(0, min(size, pool) - 1), replace=False)
    return sorted({0, *(int(k) for k in rest)})


class Keeper:
    """Copies the sampled answers to the host while the next solve runs:
    on a side stream into pinned buffers made in set-up."""

    def __init__(self, picks, like, device, wait: bool):
        self.cuda = device.type == "cuda"
        self.wait = wait
        self.slots = {k: tuple(torch.empty(a.shape, dtype=a.dtype,
                                           pin_memory=self.cuda)
                               for a in like) for k in picks}
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.kept = set()

    def keep(self, k: int, answer) -> None:
        if k not in self.slots:
            return
        if not self.cuda:
            for s, a in zip(self.slots[k], answer):
                s.copy_(a)
        else:
            self.side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.side):
                for s, a in zip(self.slots[k], answer):
                    s.copy_(a, non_blocking=True)
                    a.record_stream(self.side)
            if self.wait:
                self.side.synchronize()
        self.kept.add(k)

    def finish(self) -> None:
        if self.cuda:
            self.side.synchronize()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(root: Path, name: str, seed: int, seconds: float, trace_on: bool,
            device, t0: float) -> dict:
    """Run cell ``name`` and return ``{"line": the result line, "ok": bool}``.
    ``device`` is the card (``cuda:0``); the tests pass the CPU."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    bench = registry.load(root)
    cell = registry.workload(bench, name)
    config = registry.config(root, bench, cell["config"])
    mix = registry.traffic(root, cell["traffic"])
    entry = registry.entry(root, mix["entry"])
    grid = [int(n) for n in config["grid"]]
    stencil, spec = config["stencil"], mix["rhs"]
    rtol = float(mix["params"]["rtol"])

    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        log(f"card: {card_reading()}")
    state = entry.build(config, mix["params"], device)
    shim = None
    if trace_on:
        shim = trace.LaunchShim(registry.kernel_files(root))
        shim.install()
    t_built = time.perf_counter()

    pool = int(spec["pool"])

    def inputs(m: int):
        return entry.inputs(config, rhs.make(grid, spec, stencil, m, device))

    like, warm = None, []
    for j in range(int(mix["warm_solves"])):    # pool members 0, 1, ...
        inp = inputs(j % pool)
        _sync(device)
        t1 = time.perf_counter()
        res = entry.solve(state, inp)
        _sync(device)
        warm.append(time.perf_counter() - t1)
        like = entry.answer(res)
        entry.counts(res)
        del res, inp
    picks = sample(seed, int(mix["trace_solves"]) if trace_on
                   else int(mix["check_from"]), int(mix["check_solves"]))
    keeper = Keeper(picks, like, device, wait=trace_on)
    del like
    t_window = time.perf_counter()
    setup_s = t_window - t0
    log(f"set-up {setup_s:.3f} s (to the operator {t_built - t0:.3f} s, "
        f"{mix['warm_solves']} warm solves and buffers "
        f"{t_window - t_built:.3f} s); warm solves took "
        + ", ".join(f"{t:.4f}" for t in warm) + " s")

    times: List[float] = []
    flags: List[bool] = []
    counts: List[dict] = []
    members: List[int] = []

    def one(k: int, timed: Callable) -> None:
        members.append(rhs.member(seed, k, pool))
        inp = inputs(members[-1])
        _sync(device)
        t1 = time.perf_counter()
        res = timed(inp)
        _sync(device)
        times.append(time.perf_counter() - t1)
        flags.append(entry.converged(res))
        counts.append(entry.counts(res))
        keeper.keep(k, entry.answer(res))

    prof = None
    if not trace_on:
        k = 0
        while k % pool or time.perf_counter() - t_window < seconds:
            one(k, lambda inp: entry.solve(state, inp))
            k += 1
        window_s = time.perf_counter() - t_window
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

        def traced(inp):
            shim.tracing = True
            try:
                with record_function(trace.RANGE):
                    res = entry.solve(state, inp)
                    _sync(device)
            finally:
                shim.tracing = False
            return res

        with profile(activities=acts) as prof:
            for k in range(int(mix["trace_solves"])):
                one(k, traced)
        window_s = time.perf_counter() - t_window
        shim.uninstall()
        log("what tracing costs (pool member: untraced warm solve s, traced "
            "solve s): " + ", ".join(
                f"{j % pool}: {w:.4f}, {times[members.index(j % pool)]:.4f}"
                for j, w in enumerate(warm) if j % pool in members))
    keeper.finish()
    done = len(times)
    peak_alloc = torch.cuda.max_memory_allocated(device) if cuda else None
    peak_reserved = torch.cuda.max_memory_reserved(device) if cuda else None
    if cuda:
        log(f"card after the window: {card_reading()}")

    entry.close(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check: the plain reference judges the sampled answers ---------
    worst, rels, bad = 0.0, {}, set()
    diag, off = float(stencil["diag"]), float(stencil["off"])
    for k in sorted(keeper.kept):
        b = entry.given(inputs(members[k])).reshape(grid)
        x = entry.answer_f64(config, tuple(s.to(device) for s in keeper.slots[k]))
        rel = relative_residual(b, x.reshape(grid), diag, off)
        del b, x
        rels[k] = rel
        if not rel <= rtol:
            bad.add(k)
        if not worst > rel:          # a NaN reading stays the worst
            worst = rel if not math.isnan(worst) else worst
    unconverged = [k for k, f in enumerate(flags) if not f]
    failed = len(set(unconverged) | bad)
    compared = {"rel_residual": {"value": worst if math.isfinite(worst)
                                 else str(worst), "limit": rtol},
                "unconverged": {"value": len(unconverged), "limit": 0}}
    correct = bool(keeper.kept) and worst <= rtol and not unconverged
    log(f"{done} solves in {window_s:.3f} s ({done // pool} passes through "
        f"the pool of {pool}); per solve "
        + ", ".join(f"{key} {statistics.mean(c[key] for c in counts):g}"
                    for key in counts[0]))
    by_member: Dict[int, list] = {}
    for m, t, c in zip(members, times, counts):
        by_member.setdefault(m, [[], c])[0].append(t)
    log("by pool member (member: median solve wall s; counts): " + "; ".join(
        f"{m}: {statistics.median(ts):.4f}; "
        + ", ".join(f"{v:g}" for v in c.values())
        for m, (ts, c) in sorted(by_member.items())))
    log("checked solves (solve index/member: relative residual in f64): "
        + ", ".join(f"{k}/{members[k]}: {v!r}" for k, v in rels.items()))

    # -- metrics ----------------------------------------------------------
    wanted = registry.metrics_for(
        bench, "per_layer" if trace_on else "end_to_end", name)
    if not trace_on:
        # one quantity under two names: cells whose solve the host drives
        # launch by launch report it as solve_s.host_driven, with its bound
        values = {"solve_s": window_s / done,
                  "solve_s.host_driven": window_s / done,
                  "solve_p95_s": float(np.percentile(times, 95)),
                  "setup_s": setup_s}
        if peak_alloc is not None:
            values["peak_alloc_gib"] = peak_alloc / 2**30
        log(f"solve wall s: median {statistics.median(times)!r}, p95 "
            f"{values['solve_p95_s']!r}, max {max(times)!r} over {done}")
    else:
        ctx = layer_context(root, prof, shim, counts, done, cuda)
        values = {m["name"]: registry.metric(root, m["name"]).read(ctx)
                  for m in wanted}
        values = {k: v for k, v in values.items() if v is not None}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if m["name"] in values}
    for m in wanted:
        if m["name"] not in values:
            log(f"{m['name']}: nothing to read in this run; left out")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": peak_reserved}
    line = {"correct": correct, "attempted": done, "failed": failed,
            "metrics": metrics, "device": dev}
    if trace_on and ctx.reduced is not None:
        dev["busy_s"] = ctx.reduced.busy_s
        dev["window_s"] = ctx.reduced.window_s
        line["breakdown"] = {
            "device_ops": trace.top(ctx.reduced.by_name.items()),
            "idle_gaps": trace.top(ctx.reduced.gaps)}
    line["compared"] = compared
    for key, c in compared.items():
        log(f"compared {key} {c['value']!r} limit {c['limit']!r}")
    return {"line": line, "ok": correct}


def layer_context(root, prof, shim, counts, solves, cuda) -> SimpleNamespace:
    """What the per-layer readers read, and the per-kernel lines."""
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    files = shim.files
    counted = {s for kf in files.values() for s in kf.SYMBOLS}
    own = trace.port_symbols(Path(port.__file__).parent) | counted
    reduced = None
    if cuda:
        reduced = trace.reduce(trace.events_of(prof))
        if not reduced.by_name:
            log("the profiler saw no device time: device metrics not measured")
            reduced = None
    launch_bytes = sum(n for _, n, _ in shim.records)
    ctx = SimpleNamespace(solves=solves, counts=counts, reduced=reduced,
                          own=own, counted=counted, launch_bytes=launch_bytes)
    by_label: Dict[str, list] = {}
    for label, n, shape in shim.records:
        e = by_label.setdefault(label, [0, 0, {}])
        e[0] += 1
        e[1] += n
        e[2][shape] = e[2].get(shape, 0) + 1
    for label, (launches, n, shapes) in sorted(by_label.items()):
        log(f"launches a solve: {label}: {launches / solves:g}, bytes bound "
            f"{n / trace.PEAK_BYTES_S / solves * 1e3:.4f} ms; by shape "
            + ", ".join(f"{s} x{c / solves:g}" for s, c in shapes.items()))
    if reduced is not None:
        by_sym: Dict[str, float] = {}
        for k, v in reduced.by_name.items():
            by_sym[trace.symbol_of(k)] = by_sym.get(trace.symbol_of(k), 0.0) + v
        for sym, sec in sorted(by_sym.items(), key=lambda kv: -kv[1]):
            if sym in own:
                tag = "counted" if sym in counted else "no count file: left out of the share"
                log(f"port kernel {sym}: {sec / solves * 1e3:.4f} device ms a solve ({tag})")
        by_file: Dict[str, int] = {}
        for label, n, _ in shim.records:
            stem = label.split("[")[0]
            by_file[stem] = by_file.get(stem, 0) + n
        for stem, n in sorted(by_file.items()):
            syms = files[stem].SYMBOLS
            t = sum(v for k, v in reduced.by_name.items()
                    if trace.symbol_of(k) in syms)
            if t > 0:
                log(f"share of the bytes bound, {stem} over every launch of "
                    f"{'/'.join(syms)}: {100 * n / trace.PEAK_BYTES_S / t:.2f}% "
                    f"(3.35 TB/s; the card's power limit is on the card line)")
    return ctx
