"""Whole runs on the CPU at a tiny size: sound runs come out correct, the
control fails the limit, and each fault planted in the timed path makes
``correct`` false."""

import dataclasses

import pytest
import torch

from portbench import control, harness

torch.set_num_threads(1)

SEED = 2**31 + 77
CELLS = ["ns3d_512.stream.tiny", "p2d_4096.smsm_global.tiny",
         "p2d_4096.mgpcg_df.tiny"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace_on", [False, True])
def test_sound_run_is_correct(tiny_root, cell, trace_on):
    out = harness.execute(tiny_root, cell, SEED, 0.3, trace_on, "cpu", 0.0)
    line = out["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "compared"
    c = line["compared"]
    assert c["rel_residual"]["value"] <= c["rel_residual"]["limit"]
    assert c["unconverged"] == {"value": 0, "limit": 0}
    if trace_on:
        want = {"refine.pcg_iters", "refine.host_syncs"} if "smsm" not in cell \
            else {"multisplit.sweeps", "multisplit.inner_iters"}
        assert set(line["metrics"]) == want      # no card: no device figures
        assert line["attempted"] == (16 if "mgpcg" in cell else 8)
    else:
        solve = "solve_s.host_driven" if "smsm" in cell else "solve_s"
        assert set(line["metrics"]) >= {solve, "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(tiny_root, cell):
    rows = control.readings(tiny_root, cell, [1, SEED, SEED + 1], 2, "cpu")
    from portbench import registry

    bench = registry.load(tiny_root)
    rtol = registry.traffic(tiny_root, registry.workload(bench, cell)["traffic"])[
        "params"]["rtol"]
    for row in rows:
        assert row["converged"] and row["program"] <= rtol < row["control"], row
        assert row["control"] >= 3 * row["program"]


def _planted(monkeypatch, tiny_root, cell, fault):
    """Run ``cell`` with ``fault`` planted in the port's entry call: the
    result the window receives is altered, the port's flags left as
    they were."""
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    name = "smsm" if "smsm" in cell else "df_northstar_fused"
    real = getattr(port, name)

    def broken(op, b, **kw):
        res = real(op, b, **kw)
        if name == "smsm":
            return dataclasses.replace(res, x=fault(res.x.clone()))
        x = (res.x[0] + res.x[1].to(res.x[0].dtype)).clone()
        res.x = (fault(x), torch.zeros_like(x))
        return res

    monkeypatch.setattr(port, name, broken)
    return harness.execute(tiny_root, cell, SEED, 0.3, False, "cpu", 0.0)["line"]


def _unchanged(x):
    return torch.zeros_like(x)         # the initial guess, returned as is


def _half_left_out(x):
    flat = x.reshape(-1)
    flat[flat.numel() // 2:] = 0       # the second half of the unknowns
    return x


def _answer_altered(x):
    x.reshape(-1)[x.numel() // 3] += 1.0
    return x


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered])
def test_planted_fault_is_not_correct(monkeypatch, tiny_root, cell, fault):
    line = _planted(monkeypatch, tiny_root, cell, fault)
    assert line["correct"] is False and line["failed"] >= 1
    assert line["compared"]["rel_residual"]["value"] > \
        line["compared"]["rel_residual"]["limit"]


def test_exchange_between_blocks_left_out(monkeypatch, tiny_root):
    """Multisplitting with the blocks' coupling dropped solves the
    block-diagonal system: the port sees its own residual converge, the
    reference does not."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops

    cls = blockops.StackedStencil2D
    monkeypatch.setattr(cls, "coupling_mv", lambda self, x: torch.zeros_like(x))
    monkeypatch.setattr(cls, "full_mv", lambda self, x: self.diag_mv(x))
    line = harness.execute(tiny_root, "p2d_4096.smsm_global.tiny", SEED, 0.3,
                           False, "cpu", 0.0)["line"]
    assert line["compared"]["unconverged"]["value"] == 0
    assert line["correct"] is False


def test_unconverged_solve_is_not_correct(monkeypatch, tiny_root):
    """A solve whose flag says it did not converge fails the run, whatever
    its residual."""
    import medane_tchakorom_ufc_thesis_repository_tpu_torch as port

    real = port.df_northstar_fused

    def flagged(op, b, **kw):
        res = real(op, b, **kw)
        res.converged = False
        return res

    monkeypatch.setattr(port, "df_northstar_fused", flagged)
    line = harness.execute(tiny_root, "ns3d_512.stream.tiny", SEED, 0.3, False,
                           "cpu", 0.0)["line"]
    assert line["correct"] is False
    assert line["compared"]["unconverged"]["value"] == line["attempted"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["ns3d_512.stream", "p2d_4096.smsm_global"])
def test_control_fails_the_limit_at_the_cells_size(card, cell):
    """The same readings on the card at the cell's own size, three pool
    seeds (``python -m pytest portbench/tests -m card`` on the card)."""
    from conftest import ROOT
    from portbench import registry

    bench = registry.load(ROOT)
    rtol = registry.traffic(ROOT, registry.workload(bench, cell)["traffic"])[
        "params"]["rtol"]
    for row in control.readings(ROOT, cell, [1, 7, 13], 1, card):
        assert row["converged"] and row["program"] <= rtol < row["control"], row
        assert row["control"] >= 3 * row["program"]
