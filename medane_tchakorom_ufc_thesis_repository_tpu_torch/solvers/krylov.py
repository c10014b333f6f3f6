"""Conjugate gradients (port of the JAX package's ``solvers/krylov.cg``,
single-device order).

JAX runs the iteration as one ``lax.while_loop``.  Here it is a Python
loop: the iteration test is computed on the device, in the solve's
dtype, exactly as JAX computes it, and read on the host once per
iteration.  ``KrylovResult.syncs`` counts those reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solver output (the analog of KSPGetIterationNumber /
    KSPGetResidualNorm / KSPGetConvergedReason)."""

    x: torch.Tensor
    iters: int                 # iterations (matvecs) taken
    resnorm: torch.Tensor      # final recurrence residual norm (0-d)
    resnorm0: torch.Tensor     # initial residual norm used by the test
    converged: torch.Tensor    # 0-d bool
    syncs: int = 0             # host reads of device values


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg(
    matvec: Callable,
    b: torch.Tensor,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
    matvec_dot: Optional[Callable] = None,
    precond_dot: Optional[Callable] = None,
) -> KrylovResult:
    """Preconditioned CG for SPD systems from the zero guess, stopping on
    the TRUE residual norm ``||r||_2 <= rtol * ||b||`` (PETSc's
    unpreconditioned norm type).

    ``matvec_dot``: optional fused ``p -> (A p, p · A p)``
    (``Stencil3D.mv_dot``).  ``precond_dot``: optional fused
    ``r -> (z, r · z)`` (``mg_preconditioner(op, return_rdot=True)``);
    it takes precedence over ``precond``.  ``divtol``: stop, not
    converged, once the residual exceeds ``divtol * rnorm0`` (0
    disables).  The preconditioner runs at the start of each iteration,
    so the last iteration skips a dead apply; ``beta`` and ``alpha`` are
    guarded against zero denominators as in the JAX package, so the
    iteration counts match it.
    """
    dtype = b.dtype
    r = b   # x0 = 0 => r0 = b exactly
    rs = _vdot(r, r)
    rnorm0 = torch.sqrt(rs)
    tol = rtol * rnorm0
    div = divtol * rnorm0

    def keep_going(rs):
        keep = torch.sqrt(rs) > tol
        if divtol > 0.0:
            keep = keep & (torch.sqrt(rs) <= div)
        return bool(keep)

    x, p = torch.zeros_like(b), torch.zeros_like(b)
    rz = torch.ones((), dtype=dtype, device=b.device)
    iters = syncs = 0
    while iters < maxiter:
        syncs += 1
        if not keep_going(rs):
            break
        if precond_dot is not None:
            z, rz_loc = precond_dot(r)
            rz_new = rz_loc.to(dtype)
        else:
            z = r if precond is None else precond(r)
            rz_new = _vdot(r, z)
        if iters == 0:
            beta = torch.zeros((), dtype=dtype, device=b.device)
        else:
            nz = rz != 0
            beta = torch.where(nz, rz_new / torch.where(nz, rz, 1.0), 0.0)
        p = z + beta * p
        if matvec_dot is not None:
            ap, pap = matvec_dot(p)
        else:
            ap = matvec(p)
            pap = _vdot(p, ap)
        nz = pap != 0
        alpha = torch.where(nz, rz_new / torch.where(nz, pap, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rs = _vdot(r, r)
        rz = rz_new
        iters += 1
    rnorm = torch.sqrt(rs)
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0,
                        converged=rnorm <= tol, syncs=syncs)
