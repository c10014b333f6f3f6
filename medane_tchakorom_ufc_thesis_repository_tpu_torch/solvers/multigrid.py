"""Geometric multigrid for the 3D Poisson stencil (port of the JAX
package's ``solvers/multigrid.py``, piecewise-constant transfers).

Cell-centered factor-2 coarsening, damped-Jacobi smoothing with the
3D-optimal weight 6/7 (over ``diag``), a Chebyshev coarse solve under the
exact Dirichlet spectral bounds, and V or W cycles from the zero guess:
a fixed symmetric linear operation, valid as a CG preconditioner.  The
operators use the h^2-scaled convention (stencil (6, -1) at every level),
so the (2h)^2/h^2 scaling is a single ``4 *`` on each restricted residual.

Every fine-grid step of the cycle is one fused kernel
(``core/operators.Stencil3D``): the modified-coefficient first sweep (or
the f32 -> bf16 entry ``mv_cast``), ``residual_restrict``,
``prolong_jacobi``, and the last sweep with PCG's ``r · z``
(``jacobi_sweep_dot``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import Stencil3D
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import chebyshev

_JACOBI_OMEGA_3D = 6.0 / 7.0   # optimal high-frequency damping in 3D

# level-0 f32 bytes above which the auto cycle precision drops to bf16.
# Measured on a TPU v5e by the JAX package (wins from 256^3 up); kept
# as it is for parity until it is measured on the H100.
_BF16_CYCLE_BYTES = 32 * 2**20


def _restrict(r: torch.Tensor, dims: Tuple[int, int, int]) -> torch.Tensor:
    """Mean over each 2x2x2 cell block (cell-centered full weighting)."""
    return stencil3d.cell_sums(r.reshape(dims)) * (1.0 / 8.0)


def _prolong(e: torch.Tensor, dims: Tuple[int, int, int]) -> torch.Tensor:
    """Piecewise-constant replication of the coarse ``e`` (grid ``dims``)
    to the fine grid (R^T up to scale)."""
    return stencil3d.replicate(e.reshape(dims))


def _dirichlet_bounds(dims: Tuple[int, ...], diag: float, off: float):
    """Exact spectral interval of the (diag, off) Dirichlet stencil: the
    eigenvalues are ``diag + 2*off*sum_i cos(k_i pi/(n_i+1))``."""
    a = 2.0 * abs(off) * sum(math.cos(math.pi / (n + 1)) for n in dims)
    return diag - a, diag + a


@dataclasses.dataclass(frozen=True)
class MGLevels:
    """Static cycle description: shapes and coefficients only (the
    stencil is matrix-free, so no level stores an array)."""

    dims: Tuple[Tuple[int, int, int], ...]   # fine -> coarse grid shapes
    diag: float
    off: float
    nu: int                                  # pre/post smoothing sweeps
    coarse_iters: int
    cycle: str = "w"                         # 'w' | 'v'


def plan(op: Stencil3D, *, nu: int = 2, min_size: int = 4,
         coarse_iters: int = 40, cycle: str = "w") -> MGLevels:
    """Halve every dimension while all stay even and at least
    ``min_size``; the coarsest level takes ``coarse_iters`` Chebyshev
    steps.  ``cycle``: 'w' (two recursive solves per level) or 'v'."""
    if cycle not in ("v", "w"):
        raise ValueError(f"cycle must be 'v' or 'w', got {cycle!r}")
    if not isinstance(op, Stencil3D):
        raise TypeError(f"multigrid supports Stencil3D, got {type(op).__name__}")
    levels = [op.dims]
    while all(n % 2 == 0 and n // 2 >= min_size for n in levels[-1]):
        levels.append(tuple(n // 2 for n in levels[-1]))
    return MGLevels(dims=tuple(levels), diag=float(op.diag),
                    off=float(op.off), nu=nu, coarse_iters=coarse_iters,
                    cycle=cycle)


def vcycle(levels: MGLevels, b: torch.Tensor, level: int = 0,
           out_dtype=None, cast_dtype=None, rdot: bool = False):
    """One V or W cycle for ``A x = b`` (grid-shaped) from the zero
    guess.

    ``out_dtype``: dtype of the returned correction (default
    ``b.dtype``), written by the last sweep's kernel.  ``cast_dtype``:
    the cycle's arithmetic dtype when it differs from ``b.dtype``; the
    cast rides the first sweep (``mv_cast``).  ``rdot``: return
    ``(z, d)`` with ``d = b · z`` taken in the last sweep, or ``d = None``
    when the cycle ends without a sweep."""
    dims = levels.dims[level]
    A = Stencil3D(*dims, levels.diag, levels.off)
    omega = _JACOBI_OMEGA_3D / levels.diag

    if level == len(levels.dims) - 1:
        if cast_dtype is not None:
            b = b.to(cast_dtype)   # one-level hierarchy
        lmin, lmax = _dirichlet_bounds(dims, levels.diag, levels.off)
        x = chebyshev(A.mv, b, maxiter=levels.coarse_iters, lmin=lmin,
                      lmax=lmax).x
        x = x if out_dtype is None else x.to(out_dtype)
        return (x, None) if rdot else x

    needs_cast = cast_dtype is not None and b.dtype != cast_dtype
    if levels.nu >= 2:
        # x0 = 0 folds the first two sweeps into one stencil apply:
        # x2 = w b + w (b - A (w b)) = (2w - w^2 diag) b - w^2 off * N b
        A2 = Stencil3D(*dims, 2.0 * omega - omega * omega * levels.diag,
                       -omega * omega * levels.off)
        if needs_cast:
            x, b = A2.mv_cast(b, cast_dtype)
        else:
            x = A2.mv(b)
        presweeps = levels.nu - 2
    else:
        if needs_cast:
            b = b.to(cast_dtype)
        x = omega * b
        presweeps = levels.nu - 1
    dtype = x.dtype   # the cycle's arithmetic dtype from here on
    for _ in range(presweeps):
        x = A.jacobi_sweep(x, b, omega)

    rc = A.residual_restrict(x, b, scale=4.0)
    ec = vcycle(levels, rc, level + 1)
    if levels.cycle == "w" and level + 1 < len(levels.dims) - 1:
        # W cycle: solve the coarse problem again on its residual
        Ac = Stencil3D(*levels.dims[level + 1], levels.diag, levels.off)
        ec = ec + vcycle(levels, Ac.residual(ec, rc), level + 1)
    if levels.nu >= 1:
        x = A.prolong_jacobi(x, b, ec.to(dtype), omega)
        post = levels.nu - 1
    else:
        x = x + _prolong(ec, levels.dims[level + 1]).to(dtype)
        post = 0
    if post:
        for _ in range(post - 1):
            x = A.jacobi_sweep(x, b, omega)
        if rdot:
            return A.jacobi_sweep_dot(x, b, omega, out_dtype=out_dtype)
        return A.jacobi_sweep(x, b, omega, out_dtype=out_dtype)
    x = x if out_dtype is None else x.to(out_dtype)
    return (x, None) if rdot else x


def mg_preconditioner(op: Stencil3D, *, nu: int = 2, min_size: int = 4,
                      coarse_iters: int = 40, cycle: str = "w",
                      dtype=None, return_rdot: bool = False) -> Callable:
    """Return ``M(r) -> z ~= A^{-1} r`` (one V or W cycle; flat or
    grid-shaped ``r``), or with ``return_rdot`` ``M(r) -> (z, r · z)``
    for ``cg(precond_dot=...)``.

    ``dtype``: the cycle's arithmetic dtype (the residual is cast in, the
    correction cast back to ``r.dtype``).  ``None`` = auto: bf16 when the
    level-0 f32 grid exceeds ``_BF16_CYCLE_BYTES``, else ``r.dtype``."""
    levels = plan(op, nu=nu, min_size=min_size, coarse_iters=coarse_iters,
                  cycle=cycle)
    dims = levels.dims[0]
    if dtype is None:
        cycle_dtype = (torch.bfloat16 if 4 * math.prod(dims) > _BF16_CYCLE_BYTES
                       else None)   # None = follow the input dtype
    else:
        cycle_dtype = dtype

    def run(r: torch.Tensor, rdot: bool):
        g = r if r.dim() == 3 else r.reshape(dims)
        if cycle_dtype is not None and g.dtype != cycle_dtype:
            out = vcycle(levels, g, out_dtype=r.dtype, cast_dtype=cycle_dtype,
                         rdot=rdot)
        else:
            out = vcycle(levels, g, rdot=rdot)
        return g, out

    def M(r: torch.Tensor) -> torch.Tensor:
        _, z = run(r, False)
        return z.reshape(r.shape)

    def M_dot(r: torch.Tensor):
        """``(z, r · z)``, the dot taken in the cycle's last sweep (or an
        explicit f32 dot when the cycle ends without one)."""
        g, (z, d) = run(r, True)
        if d is None:
            d = torch.sum(g.to(torch.float32) * z.to(torch.float32))
        return z.reshape(r.shape), d

    return M_dot if return_rdot else M
