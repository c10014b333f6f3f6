"""Chebyshev iteration (port of the JAX package's ``solvers/chebyshev.py``):
the multigrid cycle's coarse solve and a multisplitting inner solve.

Each iteration is one matvec and a few axpys, with no dot products.  The
recurrence's scalars depend only on the spectral bounds, so they are
computed on the host, rounded to the solve's dtype after every operation
as JAX rounds its device scalars; the loop then launches no scalar work
and reads nothing from the device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    KrylovResult,
)


def chebyshev(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    lmin: float,
    lmax: float,
    maxiter: int = 20,
    rtol: float = 0.0,
    batched: bool = False,
) -> KrylovResult:
    """Run ``maxiter`` Chebyshev iterations from ``x0`` (default zero) for
    SPD ``A`` with eigenvalues in ``[lmin, lmax]`` (the scaled and shifted
    Chebyshev polynomial: optimal worst-case damping over the interval).

    ``batched``: ``b`` is ``(batch, n)``, one system a row (``matvec``
    maps the batch), and the norms, ``iters`` and ``converged`` are per
    system, as under the JAX package's ``vmap``.  Otherwise the norms are
    over all of ``b``.  ``converged`` reports ``rnorm <= rtol * rnorm0``
    (always False at the default rtol=0: a fixed-iteration smoother makes
    no convergence claim)."""
    dtype = b.dtype

    def rnd(v: float) -> float:
        return torch.tensor(v, dtype=dtype).item()

    def norm(v: torch.Tensor) -> torch.Tensor:
        if batched:
            return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim()))))
        return torch.sqrt(torch.sum(v * v))

    theta = rnd((lmax + lmin) / 2.0)
    delta = rnd((lmax - lmin) / 2.0)
    sigma1 = rnd(theta / delta)
    if x0 is None:
        x, r = torch.zeros_like(b), b   # x0 = 0 => r0 = b exactly
    else:
        x, r = x0, b - matvec(x0)
    rnorm0 = norm(r)
    d = r / theta
    rho = rnd(1.0 / sigma1)
    for _ in range(maxiter):
        x = x + d
        r = r - matvec(d)
        rho_new = rnd(1.0 / rnd(rnd(2.0 * sigma1) - rho))
        d = rnd(rho_new * rho) * d + rnd(rnd(2.0 * rho_new) / delta) * r
        rho = rho_new
    rnorm = norm(r)
    iters = (torch.full(rnorm.shape, maxiter, dtype=torch.int32,
                        device=b.device) if batched else maxiter)
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0,
                        converged=rnorm <= rtol * rnorm0)


def poisson_strip_eig_bounds_2d(rows: int, n: int, diag: float = 4.0,
                                off: float = -1.0):
    """Analytic spectral bounds of the Dirichlet 5-point strip operator
    A_ii on a ``rows x n`` grid: its eigenvalues are
    ``diag + 2*off*(cos(i pi/(rows+1)) + cos(j pi/(n+1)))``."""
    a = 2.0 * abs(off) * (math.cos(math.pi / (rows + 1))
                          + math.cos(math.pi / (n + 1)))
    return diag - a, diag + a


def poisson_strip_eig_bounds_3d(rows: int, ny: int, nz: int,
                                diag: float = 6.0, off: float = -1.0):
    """The same for the 7-point strip operator on ``rows x ny x nz``."""
    a = 2.0 * abs(off) * (math.cos(math.pi / (rows + 1))
                          + math.cos(math.pi / (ny + 1))
                          + math.cos(math.pi / (nz + 1)))
    return diag - a, diag + a
