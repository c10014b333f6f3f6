"""Port parity for the host-stepped multisplitting with stage timers
(``models/staged.py``).

``staged_multisplit_solve`` must equal the port's ``multisplit_solve``
to the bit: sweeps, x and the per-cycle history, for SM, AM (staleness
2, certification tail included) and the three SMSM scopes, at 32² in
f64 on the CPU.  Its sweeps must be the golden counts 42/88/36/12/12,
which the JAX package's ``staged_multisplit_solve`` reaches on the same
problem, and its four stage timers must be filled.
"""

import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.models import staged as jstaged
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    multisplitting as ms,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.staged import (
    staged_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (
    PhaseTimer,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

# (keywords of both drivers, golden sweeps)
CASES = {
    "SM": ({}, 42),
    "AM": ({"schedule": "async", "staleness": 2}, 88),
    "SMSM_LOCAL": ({"minimization": "local", "s": 4}, 36),
    "SMSM_SEMI_LOCAL": ({"minimization": "semi_local", "s": 4}, 12),
    "SMSM_GLOBAL": ({"minimization": "global", "s": 4}, 12),
}


def _problem(m=32):
    op = blockops.block_poisson2d(m, m)
    return op, blockops.rhs_ones(op, torch.float64, "cpu")


@pytest.mark.parametrize("alg", list(CASES))
def test_equals_multisplit_solve_and_jax_staged(alg):
    kw, golden = CASES[alg]
    op, b = _problem()
    maxiter = 4000 if alg == "AM" else 2000
    res = staged_multisplit_solve(op, b, rtol=1e-3, maxiter=maxiter, **kw)
    ref = ms.multisplit_solve(op, b, rtol=1e-3, maxiter=maxiter,
                              record_history=True, **kw)
    assert (res.sweeps, res.cycles) == (ref.sweeps, ref.cycles)
    assert res.converged and ref.converged
    assert (res.certified, res.tail_sweeps) == (ref.certified,
                                                ref.tail_sweeps)
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.history, ref.history[:ref.cycles])
    assert torch.equal(res.rnorm, ref.rnorm)
    assert torch.equal(res.inner_iters, ref.inner_iters)
    # the golden counts, which JAX's staged driver reaches too
    jop = jbo.block_poisson2d(32, 32)
    jres = jstaged.staged_multisplit_solve(
        jop, jbo.rhs_ones(jop, jnp.float64), rtol=1e-3, maxiter=maxiter,
        **kw)
    assert res.sweeps == int(jres.sweeps) == golden
    assert res.cycles == int(jres.cycles)


def test_stage_timers_filled():
    op, b = _problem(16)
    pt = PhaseTimer()
    res = staged_multisplit_solve(op, b, minimization="global", s=4,
                                  rtol=1e-3, maxiter=2000, timer=pt)
    assert res.converged
    stages = {name: (t, calls) for name, t, calls in pt.items()}
    assert set(stages) == {"I_Solver", "Exchange", "O_Solver", "Convergence"}
    for t, calls in stages.values():
        assert t > 0 and calls >= 1
    assert stages["I_Solver"][1] == res.sweeps
    assert stages["O_Solver"][1] == res.cycles == stages["Convergence"][1]
    lines = []
    pt.report(printer=lines.append)
    assert len(lines) == 5 and "O_Solver" in "".join(lines)


def test_history_recorded():
    op, b = _problem(16)
    res = staged_multisplit_solve(op, b, rtol=1e-3, maxiter=2000)
    assert res.history.shape == (res.cycles,)
    assert res.history[-1] <= 1e-3 * res.rnorm0
    assert res.history[-1] < res.history[0]


def test_rejects():
    op, b = _problem(8)
    with pytest.raises(ValueError, match="staleness"):
        staged_multisplit_solve(op, b, staleness=2)
    with pytest.raises(ValueError, match="schedule"):
        staged_multisplit_solve(op, b, schedule="lockstep")
