"""The cell ``p2d_1024.am`` (AM on 2D Poisson 1024^2): its declaration,
its tiny twin on the CPU as the other cells' twins are run (sound runs,
the control, planted faults), its two per-layer readers, and, on the
card, the control at the cell's size and the certification span."""

import dataclasses
import types

import pytest
import torch

from conftest import ROOT
from portbench import control, harness, registry, trace

torch.set_num_threads(1)

SEED = 2**31 + 77
CELL = "p2d_1024.am"
TINY = f"{CELL}.tiny"
PROFILING = "medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling"
LAYER = "multisplitting driver (models/multisplitting.py)"


def test_the_cell_and_its_metrics_are_declared():
    bench = registry.load(ROOT)
    cell = registry.workload(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("poisson2d_1024", "am", 1)
    assert len(cell["why"]) <= 200
    config = registry.config(ROOT, bench, "poisson2d_1024")
    assert config["grid"] == [1024, 1024] and config["blocks"] == 2
    assert config["reduced"] == []
    metrics = {m["name"]: m for m in bench["per_layer"] + bench["end_to_end"]}
    new = {"multisplit.certify_ms": ("program_span", "ms/solve"),
           "multisplit.tail_sweeps": ("program_counter", "sweeps/solve")}
    for name, (source, unit) in new.items():
        m = metrics[name]
        assert (m["source"], m["unit"], m["layer"], m["moves"]) == \
            (source, unit, LAYER, "solve_s.host_driven")
        assert m["workloads"] == [CELL]
    listed = {"solve_s.host_driven", "multisplit.sweeps",
              "multisplit.inner_iters", "multisplit.inner_ms",
              "multisplit.sync_wait_ms", "solvers.torch_device_ms.host_driven",
              "kernels.device_ms.host_driven",
              "kernels.roofline_pct.host_driven", "device.idle_pct.host_driven"}
    assert {n for n, m in metrics.items()
            if CELL in m.get("workloads", [])} == listed | set(new)


@pytest.mark.parametrize("trace_on", [False, True])
def test_sound_run_is_correct(tiny_root, trace_on):
    out = harness.execute(tiny_root, TINY, SEED, 0.3, trace_on, "cpu", 0.0)
    line = out["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "compared"
    c = line["compared"]
    assert c["rel_residual"]["value"] <= c["rel_residual"]["limit"]
    assert c["unconverged"] == {"value": 0, "limit": 0}
    if trace_on:
        # no card: the counts alone, no device figure and no span's
        assert set(line["metrics"]) == {"multisplit.sweeps",
                                        "multisplit.inner_iters",
                                        "multisplit.tail_sweeps"}
        assert line["attempted"] == 4
    else:
        assert set(line["metrics"]) >= {"solve_s.host_driven", "setup_s"}


def test_control_fails_the_limit(tiny_root):
    for row in control.readings(tiny_root, TINY, [1, SEED, SEED + 1], 2,
                                "cpu"):
        assert row["converged"] and row["program"] <= 1e-3 < row["control"], row
        assert row["control"] >= 3 * row["program"]


def _unchanged(x):
    return torch.zeros_like(x)         # the initial guess, returned as is


def _half_left_out(x):
    x.reshape(-1)[x.numel() // 2:] = 0
    return x


def _answer_altered(x):
    x.reshape(-1)[x.numel() // 3] += 1.0
    return x


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered])
def test_planted_fault_is_not_correct(monkeypatch, tiny_root, fault):
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    real = port.am

    def broken(op, b, **kw):
        res = real(op, b, **kw)
        return dataclasses.replace(res, x=fault(res.x.clone()))

    monkeypatch.setattr(port, "am", broken)
    line = harness.execute(tiny_root, TINY, SEED, 0.3, False, "cpu",
                           0.0)["line"]
    assert line["correct"] is False and line["failed"] >= 1
    assert line["compared"]["rel_residual"]["value"] > \
        line["compared"]["rel_residual"]["limit"]


def test_exchange_left_out_of_the_async_schedule(monkeypatch, tiny_root):
    """AM with the blocks' coupling dropped: the certification tail, which
    measures the coupling the port was given, certifies every solve, and
    the reference still finds the answers wrong."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops

    cls = blockops.StackedStencil2D
    monkeypatch.setattr(cls, "coupling_mv", lambda self, x: torch.zeros_like(x))
    monkeypatch.setattr(cls, "full_mv", lambda self, x: self.diag_mv(x))
    line = harness.execute(tiny_root, TINY, SEED, 0.3, False, "cpu",
                           0.0)["line"]
    assert line["compared"]["unconverged"]["value"] == 0
    assert line["correct"] is False


# two solves' totals: (calls, host s, device s)
KNOWN = {"multisplit.solve": (2, 20.0, 19.0),
         "multisplit.Certify": (2, 0.05, 0.04),
         "multisplit.sync": (500, 0.5, 0.0)}


def _read(name, counts=({}, {})):
    ctx = types.SimpleNamespace(solves=2, counts=list(counts), reduced=None)
    return registry.metric(ROOT, name).read(ctx)


def test_certify_reader_on_known_totals(monkeypatch):
    monkeypatch.setattr(PROFILING + ".totals", lambda: dict(KNOWN))
    assert _read("multisplit.certify_ms") == pytest.approx(1e3 * 0.04 / 2)


def test_certify_reader_reads_nothing_without_a_card_or_the_span(monkeypatch):
    host_only = {k: (c, h, 0.0) for k, (c, h, _) in KNOWN.items()}
    monkeypatch.setattr(PROFILING + ".totals", lambda: host_only)
    assert _read("multisplit.certify_ms") is None
    # the parent commit's port: the recorder, and no certification span
    no_span = {k: v for k, v in KNOWN.items() if k != "multisplit.Certify"}
    monkeypatch.setattr(PROFILING + ".totals", lambda: no_span)
    assert _read("multisplit.certify_ms") is None
    monkeypatch.delattr(PROFILING + ".totals")
    assert _read("multisplit.certify_ms") is None


def test_tail_sweeps_reader():
    counts = ({"multisplit.tail_sweeps": 0}, {"multisplit.tail_sweeps": 3})
    assert _read("multisplit.tail_sweeps", counts) == 1.5
    # a synchronous solve's result has no tail: nothing to read
    assert _read("multisplit.tail_sweeps",
                 ({"multisplit.tail_sweeps": None},) * 2) is None
    assert _read("multisplit.tail_sweeps") is None


@pytest.mark.card
def test_control_fails_the_limit_at_the_cells_size(card):
    """The control on the card at 1024^2, three pool seeds
    (``python -m pytest portbench/tests -m card`` on the card)."""
    for row in control.readings(ROOT, CELL, [1, 7, 13], 1, card):
        assert row["converged"] and row["program"] <= 1e-3 < row["control"], row
        assert row["control"] >= 3 * row["program"]


@pytest.mark.card
def test_certify_span_stays_off_the_device_timeline(card):
    """One tiny AM solve under the profiler on the card: the certification
    span is one host range, no device event, and it times the device."""
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import (
        profiling,
    )
    from torch.profiler import ProfilerActivity, profile

    op = port.block_poisson2d(64, 64, nblocks=2)
    b = op.full_mv(torch.ones((2, op.block_size), dtype=torch.float32,
                              device=card))
    port.am(op, b, staleness=2, rtol=1e-3)       # kernels built and loaded
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = port.am(op, b, staleness=2, rtol=1e-3)
        torch.cuda.synchronize(card)
    got = profiling.totals()
    assert r.converged and r.certified
    ev = trace.events_of(prof)
    assert got["multisplit.Certify"][0] == 1
    assert got["multisplit.Certify"][2] > 0
    assert not [e for e in ev.device if e[0] == "multisplit.Certify"]
    assert [e for e in ev.host if e[0] == "multisplit.Certify"]
