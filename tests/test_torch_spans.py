"""The span recorder (``utils/profiling.span``) and the spans of the
refinement program and the multisplitting driver, on the CPU.

Off, a span is one shared do-nothing context and records nothing; on
(``recording()`` or a ``torch.profiler`` session), spans nest and sum
by name.  A solve's spans count what its result counts: one
``refine.sync`` a host read, one ``refine.replay`` a PCG iteration or a
pass tail, one ``multisplit.I_Solver`` a sweep, one
``multisplit.O_Solver`` a cycle, and the driver's and the Krylov
solvers' read spans together its ``syncs``.  Recording changes no bit
of an iterate.
"""

import pytest
import torch

import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    multisplitting as tms,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import profiling

# one intra-op thread a process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _calls(name):
    return profiling.totals().get(name, (0, 0.0, 0.0))[0]


def test_off_span_is_the_shared_no_op():
    a, b = profiling.span("a"), profiling.span("b", torch.ones(2))
    assert a is b
    with a, b:
        pass
    assert profiling.totals() == {}


def test_spans_nest_and_accumulate():
    with profiling.recording():
        for _ in range(3):
            with profiling.span("outer"):
                with profiling.span("inner", torch.ones(2)):
                    pass
                with profiling.span("inner"):
                    pass
    got = profiling.totals()
    assert set(got) == {"outer", "inner"}
    assert got["outer"][0] == 3 and got["inner"][0] == 6
    assert got["outer"][1] >= got["inner"][1] > 0
    assert got["outer"][2] == got["inner"][2] == 0.0   # no card: host only
    profiling.reset()
    assert profiling.totals() == {}


def test_on_under_the_profiler_and_off_after():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.span("x") is not profiling.span("y")
        with profiling.span("port.stage"):
            torch.ones(4).sum()
    assert profiling.span("x") is profiling.span("y")
    assert _calls("port.stage") == 1
    names = [e.name for e in prof.events()]
    assert "port.stage" in names            # a host range on the timeline


def test_phase_timer_phases_are_spans():
    pt = profiling.PhaseTimer()
    with profiling.recording():
        for name in ("I_Solver", "Exchange", "I_Solver"):
            with pt.phase(name, fence_on=torch.ones(1)):
                pass
    assert [(n, c) for n, _, c in pt.items()] == [("I_Solver", 2),
                                                 ("Exchange", 1)]
    assert _calls("I_Solver") == 2 and _calls("Exchange") == 1


class _Event:
    """A CUDA event's timing surface: ``at`` ms, reached or not yet."""

    def __init__(self, at, reached=True):
        self.at, self.reached = at, reached

    def elapsed_time(self, end):
        if not (self.reached and end.reached):
            raise RuntimeError("CUDA error: device not ready")
        return end.at - self.at

    def synchronize(self):
        self.reached = True


def test_device_pairs_fold_without_waiting():
    """A fold stops at the first pair the card has not reached; reading
    the totals waits for it and folds the rest."""
    rec = profiling._REC
    rec.calls["x"], rec.host_ns["x"] = 3, 3000
    rec.pending += [("x", _Event(0.0), _Event(2.0)),
                    ("x", _Event(3.0), _Event(7.0, reached=False)),
                    ("x", _Event(8.0), _Event(9.0))]
    rec.fold(3)
    assert rec.device_ms == {"x": 2.0} and len(rec.pending) == 2
    assert profiling.totals() == {"x": (3, pytest.approx(3e-6),
                                        pytest.approx(7e-3))}
    assert rec.pending == []


def _northstar():
    return port.df_northstar_fused(port.poisson2d(32, 48), rtol=1e-8,
                                   device="cpu")


def test_refine_spans_count_what_the_result_counts():
    with profiling.recording():
        r = _northstar()
    assert r.converged and r.passes >= 2
    assert _calls("refine.sync") == r.syncs
    assert _calls("refine.replay") == sum(r.pcg_iters) + r.passes
    assert _calls("refine.passes") == _calls("refine.solve") == 1
    assert _calls("refine.capture") == 0     # no graph on the CPU


SMSM = [
    ("smsm_global", "smsm", {"scope": "global", "s": 4}),
    ("smsm_global_restarted", "smsm",
     {"scope": "global", "s": 4, "inner": tms.InnerConfig(restart=8)}),
    ("smsm_local_lsqr", "smsm",
     {"scope": "local", "s": 4, "outer": tms.OuterConfig(method="lsqr")}),
    ("am_stale2", "am", {"staleness": 2}),
    ("sm", "sm", {}),
]


def _multisplit(entry, kw):
    op = port.block_poisson2d(32, 32, nblocks=2)
    b = op.full_mv(torch.ones((2, op.block_size), dtype=torch.float64))
    return getattr(tms, entry)(op, b, rtol=1e-3, maxiter=2000, **kw)


@pytest.mark.parametrize("name,entry,kw", SMSM, ids=[c[0] for c in SMSM])
def test_multisplit_spans_count_what_the_result_counts(name, entry, kw):
    with profiling.recording():
        r = _multisplit(entry, kw)
    assert r.converged
    tail = r.tail_sweeps or 0
    assert _calls("multisplit.I_Solver") == r.sweeps - tail
    assert _calls("multisplit.O_Solver") == (
        r.cycles if name.startswith("smsm") else 0)
    assert _calls("multisplit.sync") + _calls("krylov.sync") == r.syncs
    assert _calls("multisplit.solve") == 1
    # the entry's exchange, then one after each sweep and each minimization
    assert _calls("multisplit.Exchange") == 1 + r.sweeps - tail + (
        r.cycles if name.startswith("smsm") else 0)
    # the entry norm, each cycle's test and, async, the certification
    certify = 1 if entry == "am" else 0
    assert _calls("multisplit.Convergence") == 1 + r.cycles + certify
    if name == "smsm_global_restarted":
        assert _calls("krylov.sync") > 0     # GMRES(8) restarts in a sweep
    if name == "smsm_local_lsqr":
        assert _calls("krylov.sync") > 0     # LSQR reads each iteration


def _iterate(which):
    if which == "refine":
        r = _northstar()
        return torch.cat([r.x[0].reshape(-1), r.x[1].reshape(-1)])
    return _multisplit("smsm", {"scope": "global", "s": 4}).x


@pytest.mark.parametrize("which", ["refine", "smsm"])
@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_recording_changes_no_bit(which, how):
    off = _iterate(which)
    if how == "recording":
        with profiling.recording():
            on = _iterate(which)
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            on = _iterate(which)
    assert profiling.totals()               # the spans were on
    assert torch.equal(off, on)
