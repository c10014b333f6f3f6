"""Entry ``am``: ``am(op, b, staleness=..., rtol=..., maxiter=...,
min_convergence_count=..., inner=InnerConfig(...))``, the thesis's
asynchronous multisplitting under bounded staleness (no minimization),
on ``block_poisson2d`` row strips of the configuration's grid
(``blocks`` of them).

Everything but the call and its counts is the ``smsm`` entry's: the
stacked f32 ``b`` of shape ``(blocks, block_size)`` in, the stacked
solution out, the answer held in bf16 as the control.  A solve has
converged when its certification tail certified it on the true
coupling."""

from __future__ import annotations

from portbench.entries import smsm
from portbench.entries.smsm import (  # noqa: F401
    answer,
    answer_f64,
    build,
    close,
    control,
    converged,
    given,
    inputs,
)


def solve(state, inp):
    return state.port.am(state.op, inp[0], inner=state.inner, **state.params)


def counts(result) -> dict:
    return dict(smsm.counts(result),
                **{"multisplit.tail_sweeps": result.tail_sweeps})
