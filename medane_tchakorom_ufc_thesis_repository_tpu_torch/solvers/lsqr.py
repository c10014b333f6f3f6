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
    cg,
)


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
) -> KrylovResult:
    """Paige-Saunders LSQR for ``min ||b - A x||_2``: Golub-Kahan
    bidiagonalization, stopping when the residual estimate drops under
    ``max(rtol ||b - A x0||, atol)`` or the estimate of ``||A^T r||``
    under ``rtol ||A^T b|| + atol`` (the least-squares optimum of an
    inconsistent system), or at ``maxiter``."""
    dtype = b.dtype
    b_eff = b if x0 is None else b - matvec(x0)
    if n is None:
        n = rmatvec(b).shape[0]
    beta0 = _norm(b_eff)
    tol = torch.clamp_min(rtol * beta0, atol)
    u = _normalize(b_eff, beta0)
    v = rmatvec(u)
    alpha0 = torch.linalg.norm(v)
    v = _normalize(v, alpha0)
    arnorm0 = alpha0 * beta0
    artol = rtol * arnorm0 + atol

    x = torch.zeros(n, dtype=dtype, device=b.device)
    w, alpha, phibar, rhobar = v, alpha0, beta0, alpha0
    rnorm, arnorm = beta0, arnorm0
    iters = syncs = 0
    while iters < maxiter:
        syncs += 1
        if not bool((rnorm > tol) & (arnorm > artol)):
            break
        u = matvec(v) - alpha * u
        beta = _norm(u)
        u = _normalize(u, beta)
        v = rmatvec(u) - beta * v
        alpha = torch.linalg.norm(v)
        v = _normalize(v, alpha)
        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        rho = torch.where(rho > 0, rho, 1.0)
        c = rhobar / rho
        s = beta / rho
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        x = x + (phi / rho) * w
        w = v - (theta / rho) * w
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
