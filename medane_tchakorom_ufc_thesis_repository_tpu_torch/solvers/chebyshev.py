"""Chebyshev iteration (port of the JAX package's ``solvers/chebyshev.py``):
the multigrid cycle's coarse solve and a multisplitting inner solve.

Each iteration is one matvec and a few axpys, with no dot products.  The
recurrence's scalars depend only on the spectral bounds, so they are
computed on the host (``chebyshev_coefficients``), rounded to the solve's
dtype after every operation as JAX rounds its device scalars; the loop
then launches no scalar work and reads nothing from the device.  The
multigrid cycle's coarse solve runs the same recurrence in one launch
(kernel M, ``ops/coarse.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.coarse import (
    Coefficients,
    chebyshev_steps,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    KrylovResult,
)


@functools.lru_cache(maxsize=1024)
def chebyshev_coefficients(lmin: float, lmax: float, maxiter: int,
                           dtype: torch.dtype) -> Coefficients:
    """The scalars of ``maxiter`` Chebyshev steps over ``[lmin, lmax]``:
    ``(theta, ((c1, c2), ...))``, step k being ``d = c1 d + c2 r``.  Each
    is rounded to ``dtype`` after every operation, as JAX rounds its
    device scalars, and read by the loop (``chebyshev``) and by kernel M
    (``ops/coarse.chebyshev_coarse``) alike."""

    def rnd(v: float) -> float:
        return torch.tensor(v, dtype=dtype).item()

    theta = rnd((lmax + lmin) / 2.0)
    delta = rnd((lmax - lmin) / 2.0)
    sigma1 = rnd(theta / delta)
    rho = rnd(1.0 / sigma1)
    steps = []
    for _ in range(maxiter):
        rho_new = rnd(1.0 / rnd(rnd(2.0 * sigma1) - rho))
        steps.append((rnd(rho_new * rho), rnd(rnd(2.0 * rho_new) / delta)))
        rho = rho_new
    return theta, tuple(steps)


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
    def norm(v: torch.Tensor) -> torch.Tensor:
        if batched:
            return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim()))))
        return torch.sqrt(torch.sum(v * v))

    if x0 is None:
        x, r = torch.zeros_like(b), b   # x0 = 0 => r0 = b exactly
    else:
        x, r = x0, b - matvec(x0)
    rnorm0 = norm(r)
    x, r = chebyshev_steps(matvec, x, r, chebyshev_coefficients(
        float(lmin), float(lmax), maxiter, b.dtype))
    rnorm = norm(r)
    iters = (torch.full(rnorm.shape, maxiter, dtype=torch.int32,
                        device=b.device) if batched else maxiter)
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0,
                        converged=rnorm <= rtol * rnorm0)


def estimate_eig_bounds(matvec: Callable, n: int,
                        dtype: torch.dtype = torch.float32, iters: int = 30,
                        seed: int = 0, safety: float = 1.05, device=None):
    """Power-iteration estimate of ``lmax`` (inflated by ``safety``) with
    ``lmin = lmax / 30``: the usual smoother heuristic when analytic
    bounds are unavailable (general DIA/ELL operators).  The start vector
    is drawn by ``torch.randn`` from a generator seeded with ``seed`` on
    ``device`` (None: the current CUDA device); JAX draws other numbers
    from the same seed, so the two estimates agree only as estimates."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import (
        resolve,
    )

    device = resolve(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    v = torch.randn(n, generator=gen, dtype=dtype, device=device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.linalg.vector_norm(w)
    lmax = float(torch.dot(v, matvec(v)) / torch.dot(v, v)) * safety
    return lmax / 30.0, lmax


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
