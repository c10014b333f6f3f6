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
bit (the same operations in the same order, the helpers of
``models.multisplitting``); wall time does not.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
    BlockOperator,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
    MultisplitResult,
    OuterConfig,
    _certification_tail,
    _local_rnorms,
    _inner_solve,
    _minimize,
    _per_block,
    _publish,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (
    PhaseTimer,
    fence,
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
    if schedule not in ("sync", "async"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    is_async = schedule == "async"
    nb, bs = op.nblocks, op.block_size
    dtype, dev = b.dtype, b.device
    if minimization is None:
        s = 1
    pt = timer if timer is not None else PhaseTimer()
    stal = ([int(staleness)] * nb if isinstance(staleness, int)
            else [int(v) for v in staleness])
    if len(stal) != nb:
        raise ValueError(f"staleness needs {nb} entries, got {len(stal)}")
    if not is_async and any(v != 1 for v in stal):
        raise ValueError("sync schedule requires staleness == 1")

    outer_u, outer_pb = _per_block(outer, nb, "OuterConfig")
    if outer_pb is not None and minimization == "global":
        raise ValueError("per-block OuterConfig needs a blockwise scope")
    outer_eff = outer_u if outer_pb is None else outer_pb[0]
    inner_solve, x_buf, rhs_buf = _inner_solve(op, inner, b)

    x = torch.zeros((nb, bs), dtype=dtype, device=dev)
    x_vis = x
    if x_buf is not None:
        x = x_buf.zero_()
    with pt.phase("Exchange", fence_on=x):
        rhs = torch.sub(b, op.coupling_mv(x_vis), out=rhs_buf)
    r0 = b - op.full_mv(x)
    rnorm0 = torch.sqrt(torch.sum(r0 * r0))
    tol_global = torch.clamp_min(rtol * rnorm0, atol)
    sqrt_nb = torch.sqrt(torch.tensor(float(nb), dtype=dtype, device=dev))
    tol_local = torch.clamp_min(rtol / sqrt_nb * rnorm0, atol)

    sweeps = cycles = syncs = 0
    inner_total = torch.zeros((), dtype=torch.int64, device=dev)
    conv_count = torch.zeros(nb, dtype=torch.int64, device=dev)
    history = []
    rnorm = rnorm0
    local_rnorms = torch.full((nb,), float("inf"), dtype=dtype, device=dev)
    outer_rnorm = torch.tensor(float("inf"), dtype=dtype, device=dev)
    syncs += 1
    converged = bool(rnorm0 <= tol_global)
    while not converged and sweeps < maxiter:
        if minimization is not None:
            S = torch.empty((s, nb, bs), dtype=dtype, device=dev)
        pub = [False] * nb
        for i in range(s):
            with pt.phase("I_Solver"):
                res = inner_solve(rhs, x)
                fence(res.x)
            syncs += res.syncs
            x = res.x
            inner_total = inner_total + res.iters.sum()
            sweeps += 1
            pub = [p or sweeps % v == 0 for p, v in zip(pub, stal)]
            with pt.phase("Exchange"):
                x_vis = _publish(stal, x, x_vis, sweeps,
                                 overwritten=x is x_buf)
                rhs = torch.sub(b, op.coupling_mv(x_vis), out=rhs_buf)
                fence(rhs)
            if minimization is not None:
                S[i] = x
        if minimization is not None:
            with pt.phase("O_Solver"):
                x, outer_rnorm, reads = _minimize(op, b, S, rhs, minimization,
                                                  outer_eff, outer_pb)
                fence(x)
            syncs += reads
            with pt.phase("Exchange"):
                x_vis = _publish(stal, x, x_vis, sweeps)
                rhs = torch.sub(b, op.coupling_mv(x_vis), out=rhs_buf)
                fence(rhs)

        with pt.phase("Convergence"):
            local_rnorms, rnorm = _local_rnorms(op, rhs, x)
            history.append(rnorm)
            cycles += 1
            if is_async:
                under = local_rnorms <= tol_local
                kept = conv_count + 1 if all(pub) else conv_count
                conv_count = torch.where(under, kept, 0)
                done = torch.all(conv_count >= min_convergence_count)
            elif minimization == "global":
                done = outer_rnorm <= tol_global
            elif minimization is not None:
                done = torch.all(local_rnorms <= tol_local)
            else:
                done = rnorm <= tol_global
            syncs += 1
            converged = bool(done)

    certified = tail_sweeps = None
    if is_async:
        with pt.phase("Convergence"):
            x, tail_sweeps, certified, rn_t, lr_t, reads = (
                _certification_tail(op, b, x, inner_solve, tol_local,
                                    converged, rhs_out=rhs_buf))
            fence(x)
        syncs += reads
        if converged:
            rnorm, local_rnorms = rn_t, lr_t
        sweeps += tail_sweeps
        converged = certified

    return MultisplitResult(
        x=x.clone() if x is x_buf else x, sweeps=sweeps, cycles=cycles,
        inner_iters=inner_total,
        rnorm=rnorm, rnorm0=rnorm0, local_rnorms=local_rnorms,
        outer_rnorm=outer_rnorm, converged=converged,
        history=torch.stack(history) if history else None,
        certified=certified, tail_sweeps=tail_sweeps, syncs=syncs)
