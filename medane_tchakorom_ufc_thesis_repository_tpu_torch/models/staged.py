"""Host-stepped multisplitting with per-stage wall timers (port of the JAX
package's ``models/staged.py``).

The same mathematics as ``models.multisplitting.multisplit_solve``, with
a device fence after each phase, so that a ``PhaseTimer`` attributes the
time to the reference's PetscLog stages
(``synchronous-multisplitting.c:52-62``):

* ``I_Solver``    -- the per-block inner Krylov sweeps,
* ``Exchange``    -- publish and the coupling right-hand side (the
  ``MPI_Sendrecv`` analog, ``comm.c:126-141``),
* ``O_Solver``    -- the s-step minimization's least squares,
* ``Convergence`` -- residual norms, the termination test and, on the
  async schedule, the certification tail.

Each fence waits for the card, so this mode is for profiling: sweeps,
iterates and the per-cycle history equal ``multisplit_solve``'s to the
bit (one loop, ``models.multisplitting._multisplit``, with a timed stage
in place of each span); wall time does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
    BlockOperator,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
    MultisplitResult,
    OuterConfig,
    _multisplit,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (
    PhaseTimer,
)


def staged_multisplit_solve(
    op: BlockOperator,
    b: torch.Tensor,
    *,
    schedule: str = "sync",
    staleness: Union[int, Sequence[int]] = 1,
    minimization: Optional[str] = None,
    s: int = 4,
    inner=InnerConfig(),
    outer=OuterConfig(),
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    timer: Optional[PhaseTimer] = None,
) -> MultisplitResult:
    """``multisplit_solve`` semantics, host-stepped with stage timers.

    Pass a ``PhaseTimer`` to collect the I_Solver / Exchange / O_Solver /
    Convergence wall times; the per-cycle residual norms are always
    recorded in ``result.history`` (one entry a cycle).
    """
    pt = timer if timer is not None else PhaseTimer()
    res = _multisplit(
        op, b, None, schedule=schedule, staleness=staleness,
        minimization=minimization, s=s, inner=inner, outer=outer, rtol=rtol,
        atol=atol, maxiter=maxiter,
        min_convergence_count=min_convergence_count, record_history=True,
        rnorm0=None, basis_collection="sweep",
        stage=lambda name, on: pt.phase(name, fence_on=b))
    return dataclasses.replace(
        res, history=res.history[:res.cycles] if res.cycles else None)
