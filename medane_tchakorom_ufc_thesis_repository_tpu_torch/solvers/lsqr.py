"""Least-squares Krylov solvers (port of the JAX package's
``solvers/lsqr.py``): LSQR and CGNE, the reference's outer methods
(``outer_solver_lsqr``/``outer_solver_cgne``) on the tall-skinny
``R = A S``.  One system each; the loop test is read on the host once
per iteration (``KrylovResult.syncs``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    KrylovResult,
    _sharded_b,
    cg,
    make_reducer,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import span


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


def _normalize(v: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    return torch.where(nrm > 0, v / torch.where(nrm > 0, nrm, 1.0), v)


def lsqr(
    matvec: Callable,
    rmatvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    n: Optional[int] = None,
    *,
    maxiter: int = 100,
    rtol: float = 1e-8,
    atol: float = 0.0,
    axis_name=None,
    lockstep_axis=None,
    mesh=None,
) -> KrylovResult:
    """Paige-Saunders LSQR for ``min ||b - A x||_2``: Golub-Kahan
    bidiagonalization, stopping when the residual estimate drops under
    ``max(rtol ||b - A x0||, atol)`` or the estimate of ``||A^T r||``
    under ``rtol ||A^T b|| + atol`` (the least-squares optimum of an
    inconsistent system), or at ``maxiter``.

    ``axis_name``/``mesh`` shard the ROW space of A: ``b`` and ``u`` are
    ``(shards, rows)``, ``x`` and ``v`` ``(shards, n)`` replicated, the
    row-space norms are reduced over ``axis_name``, and the caller's
    ``rmatvec`` reduces itself.  ``lockstep_axis``: a mesh axis whose
    shards run independent instances that must take one trip count: the
    loop runs while any instance along it is active, the others iterating
    on unmasked (their divisions are guarded), as in JAX."""
    if _sharded_b(b, axis_name, mesh):
        psum = make_reducer(axis_name, mesh)
        lock = make_reducer(lockstep_axis, mesh)

        def unorm(vec):
            return torch.sqrt(psum(torch.sum(vec * vec, dim=-1)))

        def vnorm(vec):
            return torch.linalg.vector_norm(vec, dim=-1)

        def col(t):
            return t[:, None]

        def going(live):
            return bool((lock(live.to(torch.int32)) > 0).any())
        lead = b.shape[:1]
    else:
        unorm, vnorm, going, lead = _norm, torch.linalg.norm, bool, ()

        def col(t):
            return t
    b_eff = b if x0 is None else b - matvec(x0)
    if n is None:
        n = rmatvec(b).shape[-1]
    beta0 = unorm(b_eff)
    tol = torch.clamp_min(rtol * beta0, atol)
    u = _normalize(b_eff, col(beta0))
    v = rmatvec(u)
    alpha0 = vnorm(v)
    v = _normalize(v, col(alpha0))
    arnorm0 = alpha0 * beta0
    artol = rtol * arnorm0 + atol

    x = torch.zeros(lead + (n,), dtype=b.dtype, device=b.device)
    w, alpha, phibar, rhobar = v, alpha0, beta0, alpha0
    rnorm, arnorm = beta0, arnorm0
    iters = syncs = 0
    while iters < maxiter:
        syncs += 1
        with span("krylov.sync"):
            live = going((rnorm > tol) & (arnorm > artol))
        if not live:
            break
        u = matvec(v) - col(alpha) * u
        beta = unorm(u)
        u = _normalize(u, col(beta))
        v = rmatvec(u) - col(beta) * v
        alpha = vnorm(v)
        v = _normalize(v, col(alpha))
        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        rho = torch.where(rho > 0, rho, 1.0)
        c = rhobar / rho
        s = beta / rho
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        x = x + col(phi / rho) * w
        w = v - col(theta / rho) * w
        rnorm = torch.abs(phibar)
        arnorm = torch.abs(phibar * alpha * c)
        iters += 1
    if x0 is not None:
        x = x0 + x
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=beta0,
                        converged=(rnorm <= tol) | (arnorm <= artol),
                        syncs=syncs)


def cgne(
    matvec: Callable,
    rmatvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    maxiter: int = 100,
    rtol: float = 1e-8,
    atol: float = 0.0,
) -> KrylovResult:
    """CG on the normal equations ``A^T A x = A^T b`` (KSPCGNE, the
    reference's ``outer_solver_cgne``), from ``x0`` or the zero guess."""
    atb = rmatvec(b)
    return cg(lambda v: rmatvec(matvec(v)), atb, x0, maxiter=maxiter,
              rtol=rtol, atol=atol)
