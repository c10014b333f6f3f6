"""Chebyshev iteration (port of the JAX package's
``solvers/chebyshev.chebyshev``): the multigrid cycle's coarse solve.

Each iteration is one matvec and a few axpys, with no dot products.  The
recurrence's scalars depend only on the spectral bounds, so they are
computed on the host, rounded to the solve's dtype after every operation
as JAX rounds its device scalars; the loop then launches no scalar work.
"""

from __future__ import annotations

from typing import Callable

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    KrylovResult,
)


def chebyshev(
    matvec: Callable,
    b: torch.Tensor,
    *,
    lmin: float,
    lmax: float,
    maxiter: int = 20,
    rtol: float = 0.0,
) -> KrylovResult:
    """Run ``maxiter`` Chebyshev iterations from the zero guess for SPD
    ``A`` with eigenvalues in ``[lmin, lmax]`` (the scaled and shifted
    Chebyshev polynomial: optimal worst-case damping over the interval).
    ``converged`` reports
    ``rnorm <= rtol * rnorm0`` (always False at the default rtol=0: a
    fixed-iteration smoother makes no convergence claim)."""
    dtype = b.dtype

    def rnd(v: float) -> float:
        return torch.tensor(v, dtype=dtype).item()

    theta = rnd((lmax + lmin) / 2.0)
    delta = rnd((lmax - lmin) / 2.0)
    sigma1 = rnd(theta / delta)
    x, r = torch.zeros_like(b), b   # x0 = 0 => r0 = b exactly
    rnorm0 = torch.sqrt(torch.sum(r * r))
    d = r / theta
    rho = rnd(1.0 / sigma1)
    for _ in range(maxiter):
        x = x + d
        r = r - matvec(d)
        rho_new = rnd(1.0 / rnd(rnd(2.0 * sigma1) - rho))
        d = rnd(rho_new * rho) * d + rnd(rnd(2.0 * rho_new) / delta) * r
        rho = rho_new
    rnorm = torch.sqrt(torch.sum(r * r))
    return KrylovResult(x=x, iters=maxiter, resnorm=rnorm, resnorm0=rnorm0,
                        converged=rnorm <= rtol * rnorm0)
