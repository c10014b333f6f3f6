"""The program-span metrics (``portbench/spans.py`` and their readers) on
known totals, and on the card: the port's spans leave the profiler's
device events as they are and time the device."""

import types

import pytest
import torch

from conftest import ROOT
from portbench import registry, trace

torch.set_num_threads(1)

PROFILING = "medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling"

# two solves' totals: (calls, host s, device s)
KNOWN = {
    "refine.solve": (2, 0.30, 0.28),
    "refine.passes": (2, 0.28, 0.26),
    "refine.replay": (24, 0.010, 0.25),
    "refine.sync": (32, 0.20, 0.0),
    "multisplit.solve": (2, 2.0, 1.9),
    "multisplit.I_Solver": (28, 0.9, 1.1),
    "multisplit.O_Solver": (8, 0.3, 0.8),
    "multisplit.sync": (10, 0.5, 0.0),
    "krylov.sync": (4, 0.1, 0.0),
}
WANT = {
    "refine.loop_idle_ms": 1e3 * (0.26 - 0.25) / 2,
    "refine.launch_ms": 1e3 * 0.010 / 2,
    "multisplit.minimize_ms": 1e3 * 0.8 / 2,
    "multisplit.inner_ms": 1e3 * 1.1 / 2,
    "multisplit.sync_wait_ms": 1e3 * (0.5 + 0.1) / 2,
}


def _read(name):
    ctx = types.SimpleNamespace(solves=2, counts=[{}, {}], reduced=None)
    return registry.metric(ROOT, name).read(ctx)


def test_the_span_metrics_are_declared():
    bench = registry.load(ROOT)
    spans = {m["name"]: m for m in bench["per_layer"]
             if m["source"] == "program_span"}
    assert set(spans) == set(WANT)
    for name, m in spans.items():
        assert m["unit"] == "ms/solve" and m["better"] == "lower"
        cell = "ns3d_512.stream" if name.startswith("refine.") \
            else "p2d_4096.smsm_global"
        assert m["workloads"] == [cell]


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_known_totals(monkeypatch, name):
    monkeypatch.setattr(PROFILING + ".totals", lambda: dict(KNOWN))
    assert _read(name) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_a_card_reads_nothing(monkeypatch, name):
    host_only = {k: (c, h, 0.0) for k, (c, h, _) in KNOWN.items()}
    monkeypatch.setattr(PROFILING + ".totals", lambda: host_only)
    assert _read(name) is None
    monkeypatch.setattr(PROFILING + ".totals", lambda: {})
    assert _read(name) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_port_without_the_recorder(monkeypatch, name):
    """The parent commit's port has no ``totals``: the metric is left
    out, and nothing raises."""
    monkeypatch.delattr(PROFILING + ".totals")
    assert _read(name) is None


@pytest.mark.card
def test_spans_stay_off_the_device_timeline(card):
    """One tiny solve of each program under the profiler on the card (
    ``python -m pytest portbench/tests -m card``): no device event bears a
    port span's name, and the device-timed spans read above 0."""
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import (
        profiling,
    )
    from torch.profiler import ProfilerActivity, profile

    op3 = port.poisson3d(32, 32, 32)
    bhi = op3.mv(torch.ones(op3.dims, dtype=torch.float32, device=card))
    pair = (bhi, torch.zeros_like(bhi))
    op2 = port.block_poisson2d(64, 64, nblocks=2)
    b2 = op2.full_mv(torch.ones((2, op2.block_size), dtype=torch.float32,
                                device=card))
    for _ in range(2):          # the graphs are captured before the profile
        port.df_northstar_fused(op3, pair, rtol=1e-8)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r3 = port.df_northstar_fused(op3, pair, rtol=1e-8)
        r2 = port.smsm(op2, b2, scope="global", s=4, rtol=1e-3)
        torch.cuda.synchronize(card)
    got = profiling.totals()
    assert r3.converged and r2.converged
    ev = trace.events_of(prof)
    names = set(got)
    assert {"refine.replay", "refine.passes", "multisplit.O_Solver"} <= names
    assert not [e for e in ev.device if e[0] in names]
    assert names <= {e[0] for e in ev.host}       # host ranges, on the CPU side
    for name in ("refine.solve", "refine.passes", "refine.replay",
                 "multisplit.solve", "multisplit.I_Solver",
                 "multisplit.O_Solver"):
        assert got[name][2] > 0, name
    assert got["refine.replay"][0] == sum(r3.pcg_iters) + r3.passes
    assert got["refine.passes"][2] >= got["refine.replay"][2]
