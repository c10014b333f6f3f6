"""The multisplitting inner solve as a CUDA graph
(``models/multisplitting._InnerGraph``), and the one graph runner
(``ops/build.GraphRunner``) it shares with the refinement program.

CPU tests: which inner configs and devices replay a graph (``_graphed``),
and the runner in the drivers with a stand-in graph whose ``replay()``
re-runs the captured step (``ops/build.CountedGraph`` takes anything with
``replay()``): the same sweeps, inner iterations and bits of ``x`` as the
eager solve, one capture, one replay an inner solve but the warm-up, and
a published iterate that the next replay leaves as it was; the same for
both owners of the runner.

Card tests (marker ``card``; they skip without a card, and run there with
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_inner_graph.py``): AM 1024² at staleness 2 and
SMSM_GLOBAL 1024² graphed against eager (x to the bit, sweeps, each
kernel's launches), SM on a stacked ELL operator, and the graphed AM
solve's peak of allocated memory against the eager one's.
"""

import contextlib

import pytest
import torch

import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    multisplitting as ms,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.staged import (
    staged_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import refine
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import profiling

# one intra-op thread a process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

IC = ms.InnerConfig


# ---------------------------------------------------------------------------
# Which inner solves replay a graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,device,want", [
    (IC(), "cuda", True),                    # the reference's default
    (IC(), "cuda:0", True),
    (IC(), "cpu", False),
    (IC(pc="jacobi"), "cuda", True),
    (IC(basis="bf16", orthog="cgs"), "cuda", True),
    (IC(restart=20, maxiter=20), "cuda", True),
    (IC(restart=5, maxiter=5), "cuda", True),
    (IC(restart=10, maxiter=20), "cuda", False),   # two cycles: a read
    (IC(restart=30, maxiter=40), "cuda", False),
    (IC(maxiter=0), "cuda", False),
    (IC(pc="mg"), "cuda", False),
    (IC(pc="bjacobi"), "cuda", False),
    (IC(method="cg"), "cuda", False),
    (IC(method="bicgstab"), "cuda", False),
    (IC(method="chebyshev"), "cuda", False),
    (IC(method="ca_gmres"), "cuda", False),
])
def test_which_inner_solves_are_graphed(cfg, device, want):
    assert ms._graphed(cfg, device) is want
    assert ms._graphed(cfg, torch.device(device)) is want


# ---------------------------------------------------------------------------
# The runner, with a stand-in graph
# ---------------------------------------------------------------------------

class Rerun:
    """A stand-in CUDA graph.  Its capture (a null context) runs the
    step, which is then that call's work, so the replay right after the
    capture does nothing; every later ``replay()`` runs the step again."""

    def __init__(self, step):
        self.step, self.fresh = step, True

    def replay(self):
        if self.fresh:
            self.fresh = False
        else:
            self.step()


@pytest.fixture()
def stand_in(monkeypatch):
    """The graph runner (``ops/build.GraphRunner``) on the CPU, each
    capture a ``Rerun``; yields the list of the graphs made."""
    made = []

    def new_graph(runner, step):
        made.append(Rerun(step))
        return made[-1], contextlib.nullcontext

    monkeypatch.setattr(build, "_graphs_on", lambda device: True)
    monkeypatch.setattr(build.GraphRunner, "_new_graph", new_graph)
    ms._inner_graph.cache_clear()
    refine._df_fused_program.cache_clear()
    profiling.reset()
    yield made
    ms._inner_graph.cache_clear()
    refine._df_fused_program.cache_clear()
    profiling.reset()


def _op_b(m=32, n=32, nblocks=2):
    op = port.block_poisson2d(m, n, nblocks=nblocks)
    b = op.full_mv(torch.ones((nblocks, op.block_size), dtype=torch.float64))
    return op, b


SOLVES = {
    "am_staleness_2": lambda op, b: port.am(op, b, staleness=2, rtol=1e-3),
    "am_staleness_1_3": lambda op, b: port.am(op, b, staleness=[1, 3],
                                              rtol=1e-3),
    "smsm_global": lambda op, b: port.smsm(op, b, scope="global", s=4,
                                           rtol=1e-3),
    "amam_local": lambda op, b: port.amam(op, b, scope="local", s=3,
                                          rtol=1e-3),
    "sm_jacobi": lambda op, b: port.sm(op, b, rtol=1e-3,
                                       inner=IC(pc="jacobi")),
    "staged_am": lambda op, b: staged_multisplit_solve(
        op, b, schedule="async", staleness=2, rtol=1e-3),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_graphed_solve_equals_eager(name, stand_in, monkeypatch):
    op, b = _op_b()
    solve = SOLVES[name]
    with monkeypatch.context() as m:
        m.setattr(ms, "_graphed", lambda cfg, device: False)
        eager = solve(op, b)
    with profiling.recording():
        first = solve(op, b)
        again = solve(op, b)
    # read after the second solve: the first answer is its own, not the
    # runner's buffer
    for got in (first, again):
        assert got.sweeps == eager.sweeps and got.cycles == eager.cycles
        assert int(got.inner_iters) == int(eager.inner_iters)
        assert got.tail_sweeps == eager.tail_sweeps
        assert got.converged == eager.converged
        assert torch.equal(got.x, eager.x)
    # one capture, cached across solves; every inner solve but the first
    # (the warm-up) a replay
    assert len(stand_in) == 1 and ms._inner_graph.cache_info().currsize == 1
    got = profiling.totals()
    assert got["multisplit.capture"][0] == 1
    assert got["multisplit.replay"][0] == 2 * eager.sweeps - 1


# (solve, span prefix, graphs, step calls a solve)
OWNERS = {
    "refine_16": (lambda: port.df_northstar_fused(
        port.poisson3d(16, 16, 16), rtol=1e-8, device="cpu"), "refine", 2,
        lambda r: sum(r.pcg_iters) + r.passes),
    "am_32": (lambda: port.am(*_op_b(), staleness=2, rtol=1e-3),
              "multisplit", 1, lambda r: r.sweeps),
}


def _bits(r):
    return r.x if isinstance(r.x, tuple) else (r.x,)


@pytest.mark.parametrize("name", sorted(OWNERS))
def test_one_runner_for_both_owners(name, stand_in, monkeypatch):
    """The refinement program's two steps and the inner sweep run through
    one runner: one capture a graph, the warm-up call's answer its own,
    every later call a replay, all bit-equal to the eager solve."""
    solve, prefix, graphs, steps = OWNERS[name]
    with monkeypatch.context() as m:
        m.setattr(build, "_graphs_on", lambda device: False)
        eager = solve()
    with profiling.recording():
        first = solve()             # warm-ups, captures and replays
        again = solve()             # replays alone
    for got in (first, again):
        assert steps(got) == steps(eager) and got.converged
        assert all(torch.equal(g, e) for g, e in zip(_bits(got),
                                                     _bits(eager)))
    assert len(stand_in) == graphs
    got = profiling.totals()
    assert got[prefix + ".capture"][0] == graphs
    assert got[prefix + ".replay"][0] == 2 * steps(eager) - graphs


def test_published_iterate_survives_the_next_replay(stand_in):
    """AM at staleness 2: the iterate every block publishes on sweep 2 is
    what the exchange reads after sweep 3, although sweep 3 solves into the
    same buffer; at staleness 1 the next sweep publishes again, and no copy
    is made."""
    op, b = _op_b()
    runner, x, _ = ms._inner_solve(op, IC(), b)
    x.zero_()
    x_vis = torch.zeros_like(x)
    rhs = torch.sub(b, op.coupling_mv(x_vis), out=runner.rhs)
    stal = [2, 2]
    for sweep in (1, 2):
        x = runner(rhs, x).x
        x_vis = ms._publish(stal, x, x_vis, sweep, overwritten=True)
        rhs = torch.sub(b, op.coupling_mv(x_vis), out=runner.rhs)
    assert x is runner.x and x_vis is not x
    published = x_vis.clone()
    x = runner(rhs, x).x                               # sweep 3
    assert not torch.equal(x, published)
    assert torch.equal(x_vis, published)
    assert ms._publish(stal, x, x_vis, 3, overwritten=True) is x_vis
    assert ms._publish([1, 1], x, x_vis, 3, overwritten=True) is x
    assert ms._publish(stal, x, x_vis, 4) is x


def test_per_block_configs_stay_eager(stand_in):
    op, b = _op_b()
    assert ms._inner_solve(op, [IC(), IC(rtol=1e-4)], b)[1] is None
    assert ms._inner_solve(op, [IC(), IC()], b)[1] is not None
    assert ms._inner_solve(op, IC(method="cg"), b)[1] is None
    ms._inner_graph.cache_clear()
    got = port.sm(op, b, rtol=1e-3, inner=[IC(), IC(rtol=1e-4)])
    assert got.converged and not stand_in
    assert ms._inner_graph.cache_info().currsize == 0


def test_a_foreign_x_is_copied_in(stand_in):
    """Tensors other than the runner's buffers are copied in and left as
    they were; the result lands in the runner's ``x``."""
    op, b = _op_b()
    solve = ms._make_single_inner(op, IC())
    runner = ms._inner_solve(op, IC(), b)[0]
    rhs = b - op.coupling_mv(torch.zeros_like(b))
    x0 = torch.full_like(b, 0.25)
    kept = x0.clone()
    for _ in range(3):                      # warm-up, capture, replay
        got = runner(rhs, x0)
        assert got.x is runner.x and torch.equal(x0, kept)
        assert torch.equal(got.x, solve(rhs, x0).x)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    torch.cuda.set_device(0)
    ms._inner_graph.cache_clear()
    yield torch.device("cuda", 0)
    ms._inner_graph.cache_clear()


def _both(monkeypatch, solve):
    """``(eager result, its launches, graphed result, its launches)``; the
    graphed solve runs twice (capture, then replays alone)."""
    def run():
        build.reset_launch_counts()
        r = solve()
        torch.cuda.synchronize()
        return r, dict(build.launch_counts())

    with monkeypatch.context() as m:
        m.setattr(ms, "_graphed", lambda cfg, device: False)
        eager, eager_n = run()
    first, first_n = run()
    graphed, graphed_n = run()
    assert torch.equal(first.x, graphed.x)
    assert first_n == graphed_n
    return eager, eager_n, graphed, graphed_n


CARD_SOLVES = {
    "am_1024": lambda op, b: port.am(op, b, staleness=2, rtol=1e-3,
                                     maxiter=4000),
    "smsm_global_1024": lambda op, b: port.smsm(op, b, scope="global", s=4,
                                                rtol=1e-3),
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CARD_SOLVES))
def test_card_graphed_equals_eager(card, monkeypatch, name):
    op = port.block_poisson2d(1024, 1024, nblocks=2)
    b = op.full_mv(torch.ones((2, op.block_size), dtype=torch.float32,
                              device=card))
    eager, eager_n, graphed, graphed_n = _both(
        monkeypatch, lambda: CARD_SOLVES[name](op, b))
    assert eager.converged and graphed.converged
    assert graphed.sweeps == eager.sweeps
    assert int(graphed.inner_iters) == int(eager.inner_iters)
    assert torch.equal(graphed.x, eager.x)
    assert graphed_n == eager_n
    assert {"stencil2d_apply[mv]", "mdot", "maxpy"} <= set(eager_n)


@pytest.mark.card
@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_card_stacked_ell(card, monkeypatch, pc):
    """SM on the stacked ELL operator of 2D Poisson 256² (kernel H in
    ``diag_mv``), graphed against eager."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson

    a_ii, a_ic = port.block_split_ell(*poisson.poisson2d_coo(256, 256),
                                      nblocks=2, dtype=torch.float32,
                                      device=card)
    op = port.StackedELLOperator(a_ii=a_ii, a_ic=a_ic)
    b = op.full_mv(torch.ones((2, op.block_size), dtype=torch.float32,
                              device=card))
    eager, eager_n, graphed, graphed_n = _both(
        monkeypatch, lambda: port.sm(op, b, rtol=1e-3, inner=IC(pc=pc)))
    assert eager.converged and graphed.converged
    assert graphed.sweeps == eager.sweeps
    assert torch.equal(graphed.x, eager.x)
    assert graphed_n == eager_n and eager_n["csr_mv"] > 0


@pytest.mark.card
def test_card_graphed_peak_memory(card, monkeypatch):
    """The first graphed AM 1024² solve (warm-up and capture included)
    allocates at its peak no more than the eager solve."""
    op = port.block_poisson2d(1024, 1024, nblocks=2)
    b = op.full_mv(torch.ones((2, op.block_size), dtype=torch.float32,
                              device=card))

    def peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(card)
        r = port.am(op, b, staleness=2, rtol=1e-3, maxiter=4000)
        torch.cuda.synchronize()
        assert r.converged
        return torch.cuda.max_memory_allocated(card)

    with monkeypatch.context() as m:
        m.setattr(ms, "_graphed", lambda cfg, device: False)
        eager = peak()
    ms._inner_graph.cache_clear()
    torch.cuda.empty_cache()
    assert peak() <= eager
