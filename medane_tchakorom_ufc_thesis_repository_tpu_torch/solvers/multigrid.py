"""Geometric multigrid for the 2D and 3D Poisson stencils (port of the
JAX package's ``solvers/multigrid.py``).

Cell-centered factor-2 coarsening, damped-Jacobi smoothing with the
dimension-optimal weight (4/5 in 2D, 6/7 in 3D, over ``diag``), a
Chebyshev coarse solve under the exact Dirichlet spectral bounds (one
launch of kernel M, ``ops/coarse.py``, on a coarsest grid of at most
``coarse.MAX_POINTS`` points), and V or W cycles from the zero guess: a
fixed symmetric linear operation, valid as a CG preconditioner.  The operators use the h^2-scaled
convention (stencil (2d, -1) at every level), so the (2h)^2/h^2 scaling
is a single ``4 *`` on each restricted residual.  Transfers are
piecewise constant (``'pwc'``: mean restriction, replication) or linear
(``'linear'``: bi-/trilinear prolongation with the matched full
weighting).

In 3D with ``'pwc'`` transfers every fine-grid step of the cycle is one
fused kernel (``core/operators.Stencil3D``): the modified-coefficient
first sweep (or the f32 -> bf16 entry ``mv_cast``), ``residual_restrict``,
``prolong_jacobi``, and the last sweep with PCG's ``r · z``
(``jacobi_sweep_dot``).  ``Stencil2D`` has only ``mv``, as in the JAX
package: the 2D cycle is kernel E for every apply and plain tensor code
for the sweeps and transfers, and so are the ``'linear'`` transfers in
3D.  A 2D cycle also takes a stack of grids (leading axes of ``b``), one
independent problem each: the multisplitting strips under ``pc='mg'``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    Stencil2D,
    Stencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import coarse
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    chebyshev,
    chebyshev_coefficients,
)

_JACOBI_OMEGA = {2: 0.8, 3: 6.0 / 7.0}   # optimal high-frequency damping

# level-0 f32 bytes above which the auto cycle precision drops to bf16:
# the JAX package's value, kept for parity.  On an NVIDIA H100 80GB HBM3
# (700 W; chip_smoke.py's cycle-precision phase, three calls) one cycle
# is bound by its launches, not its bytes, and bf16 moves it little either
# way: bf16/f32 time 0.93-1.10 for a W-cycle at 128^3 (8 MiB), 0.71-1.10
# at 256^3 (64 MiB), 0.90-1.26 at 2048^2 (16 MiB), 0.85-0.95 at 8192^2
# (256 MiB), 0.89-0.98 for a V-cycle there.  The 3D north-star converges
# alike with both.  In 2D, where the sweeps are plain tensor code that
# rounds every operation to bf16, a bf16 V-cycle stops PCG converging
# (40 iterations at 2048^2 and up, against 10-12 in f32); the default
# W-cycle absorbs it (4 iterations either way at 2048^2 and 4096^2).
_BF16_CYCLE_BYTES = 32 * 2**20


def _op_dims(op) -> Tuple[int, ...]:
    if isinstance(op, Stencil2D):
        return (op.m, op.n)
    if isinstance(op, Stencil3D):
        return (op.nx, op.ny, op.nz)
    raise TypeError(f"multigrid supports Stencil2D/Stencil3D operators, got "
                    f"{type(op).__name__}")


def _make_op(dims: Tuple[int, ...], diag: float, off: float):
    if len(dims) == 2:
        return Stencil2D(dims[0], dims[1], diag, off)
    return Stencil3D(dims[0], dims[1], dims[2], diag, off)


def _grid_axes(t: torch.Tensor, nd: int):
    """The last ``nd`` axes of ``t``, leading first (any axes before them
    are a batch of grids)."""
    return range(t.dim() - nd, t.dim())


def _restrict(r: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Mean over each 2x2(x2) cell block of the fine grid ``dims``
    (cell-centered full weighting): pair sums over the leading axis
    first, the last axis last, then one scale."""
    nd = len(dims)
    out = r
    for ax in _grid_axes(out, nd):
        idx = [slice(None)] * out.dim()
        lo, hi = list(idx), list(idx)
        lo[ax], hi[ax] = slice(0, None, 2), slice(1, None, 2)
        out = out[tuple(lo)] + out[tuple(hi)]
    return out * (1.0 / (2 ** nd))


def _prolong(e: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Piecewise-constant replication of the coarse ``e`` (grid ``dims``)
    to the fine grid (R^T up to scale)."""
    nd = len(dims)
    for ax in _grid_axes(e, nd):
        e = e.repeat_interleave(2, dim=ax)
    return e


def _axis_blend(g: torch.Tensor, ax: int) -> torch.Tensor:
    """The 1D linear-interpolation blend on a fine axis (cell-centered
    factor 2): an even index mixes 3/4 of itself with 1/4 of its lower
    neighbour, an odd one with its upper neighbour (clamped at the
    boundary).  The operator is symmetric, so it serves the linear
    prolongation ``P = B U`` and the matched full weighting ``R = (1/2^d)
    U^T B`` alike, and the cycle stays a symmetric preconditioner."""
    n = g.shape[ax]
    down = torch.cat([g.narrow(ax, 0, 1), g.narrow(ax, 0, n - 1)], dim=ax)
    up = torch.cat([g.narrow(ax, 1, n - 1), g.narrow(ax, n - 1, 1)], dim=ax)
    shape = [1] * g.dim()
    shape[ax] = n
    even = (torch.arange(n, device=g.device) % 2 == 0).reshape(shape)
    nb = torch.where(even, down, up)
    return (1 - 0.25) * g + 0.25 * nb


def _prolong_lin(e: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Trilinear (bilinear in 2D) prolongation: replication, then the
    blend along each grid axis."""
    g = _prolong(e, dims)
    for ax in _grid_axes(g, len(dims)):
        g = _axis_blend(g, ax)
    return g


def _restrict_lin(r: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Full weighting matched to ``_prolong_lin`` (R proportional to P^T;
    the blend is symmetric, so it is applied on the fine grid first)."""
    g = r
    for ax in _grid_axes(g, len(dims)):
        g = _axis_blend(g, ax)
    return _restrict(g, dims)


def _dirichlet_bounds(dims: Tuple[int, ...], diag: float, off: float):
    """Exact spectral interval of the (diag, off) Dirichlet stencil: the
    eigenvalues are ``diag + 2*off*sum_i cos(k_i pi/(n_i+1))``."""
    a = 2.0 * abs(off) * sum(math.cos(math.pi / (n + 1)) for n in dims)
    return diag - a, diag + a


@dataclasses.dataclass(frozen=True)
class MGLevels:
    """Static cycle description: shapes and coefficients only (the
    stencils are matrix-free, so no level stores an array)."""

    dims: Tuple[Tuple[int, ...], ...]        # fine -> coarse grid shapes
    diag: float
    off: float
    nu: int                                  # pre/post smoothing sweeps
    coarse_iters: int
    cycle: str = "w"                         # 'w' | 'v'
    transfers: str = "pwc"                   # 'pwc' | 'linear'


def plan(op, *, nu: int = 2, min_size: int = 4, max_levels: int = 32,
         coarse_iters: int = 40, cycle: str = "w",
         transfers: str = "pwc") -> MGLevels:
    """The level hierarchy of a ``Stencil2D`` or ``Stencil3D``: halve every
    dimension while all stay even and at least ``min_size`` (at most
    ``max_levels`` levels); the coarsest level takes ``coarse_iters``
    Chebyshev steps.  ``cycle``: 'w' (two recursive solves per level) or
    'v'.  ``transfers``: 'pwc' (piecewise constant) or 'linear'."""
    if cycle not in ("v", "w"):
        raise ValueError(f"cycle must be 'v' or 'w', got {cycle!r}")
    if transfers not in ("pwc", "linear"):
        raise ValueError(
            f"transfers must be 'pwc' or 'linear', got {transfers!r}")
    levels = [_op_dims(op)]
    while len(levels) < max_levels and all(
            n % 2 == 0 and n // 2 >= min_size for n in levels[-1]):
        levels.append(tuple(n // 2 for n in levels[-1]))
    return MGLevels(dims=tuple(levels), diag=float(op.diag),
                    off=float(op.off), nu=nu, coarse_iters=coarse_iters,
                    cycle=cycle, transfers=transfers)


def vcycle(levels: MGLevels, b: torch.Tensor, level: int = 0,
           out_dtype=None, cast_dtype=None, rdot: bool = False):
    """One V or W cycle for ``A x = b`` (grid-shaped; in 2D leading axes
    are a stack of grids) from the zero guess.

    ``out_dtype``: dtype of the returned correction (default
    ``b.dtype``), written by the last sweep's kernel where the operator
    has one.  ``cast_dtype``: the cycle's arithmetic dtype when it
    differs from ``b.dtype``; the cast rides the first sweep where the
    operator has ``mv_cast``.  ``rdot``: return ``(z, d)`` with
    ``d = b · z`` taken in the last sweep, or ``d = None`` when the cycle
    ends without a sweep that carries the dot.

    The fused steps are taken from the operator where it has them
    (``Stencil3D``) and composed from ``mv`` where it does not
    (``Stencil2D``), as in the JAX package."""
    dims = levels.dims[level]
    A = _make_op(dims, levels.diag, levels.off)
    omega = _JACOBI_OMEGA[len(dims)] / levels.diag

    if level == len(levels.dims) - 1:
        if cast_dtype is not None:
            b = b.to(cast_dtype)   # one-level hierarchy
        lmin, lmax = _dirichlet_bounds(dims, levels.diag, levels.off)
        if coarse.fits(dims, levels.coarse_iters):
            # kernel M: every step in one launch, the loop's bits
            x = coarse.chebyshev_coarse(
                b.contiguous(), dims=dims, diag=levels.diag, off=levels.off,
                coefs=chebyshev_coefficients(lmin, lmax, levels.coarse_iters,
                                             b.dtype))
        else:
            x = chebyshev(A.mv, b, maxiter=levels.coarse_iters, lmin=lmin,
                          lmax=lmax).x
        x = x if out_dtype is None else x.to(out_dtype)
        return (x, None) if rdot else x

    smooth = getattr(A, "jacobi_sweep",
                     lambda x_, b_, w: x_ + w * (b_ - A.mv(x_)))
    resid = getattr(A, "residual", lambda x_, b_: b_ - A.mv(x_))
    needs_cast = cast_dtype is not None and b.dtype != cast_dtype
    if levels.nu >= 2:
        # x0 = 0 folds the first two sweeps into one stencil apply:
        # x2 = w b + w (b - A (w b)) = (2w - w^2 diag) b - w^2 off * N b
        A2 = _make_op(dims, 2.0 * omega - omega * omega * levels.diag,
                      -omega * omega * levels.off)
        if needs_cast and hasattr(A2, "mv_cast"):
            x, b = A2.mv_cast(b, cast_dtype)
        else:
            if needs_cast:
                b = b.to(cast_dtype)
            x = A2.mv(b)
        presweeps = levels.nu - 2
    else:
        if needs_cast:
            b = b.to(cast_dtype)
        x = omega * b
        presweeps = levels.nu - 1
    dtype = x.dtype   # the cycle's arithmetic dtype from here on
    for _ in range(presweeps):
        x = smooth(x, b, omega)

    linear = levels.transfers == "linear"
    if not linear and hasattr(A, "residual_restrict"):
        rc = A.residual_restrict(x, b, scale=4.0)
    else:
        r = resid(x, b)
        rc = 4.0 * (_restrict_lin(r, dims) if linear else _restrict(r, dims))
    ec = vcycle(levels, rc, level + 1)
    if levels.cycle == "w" and level + 1 < len(levels.dims) - 1:
        # W cycle: solve the coarse problem again on its residual
        Ac = _make_op(levels.dims[level + 1], levels.diag, levels.off)
        resid_c = getattr(Ac, "residual", lambda x_, b_: b_ - Ac.mv(x_))
        ec = ec + vcycle(levels, resid_c(ec, rc), level + 1)
    post = levels.nu
    if levels.nu >= 1 and not linear and hasattr(A, "prolong_jacobi"):
        x = A.prolong_jacobi(x, b, ec.to(dtype), omega)
        post = levels.nu - 1
    else:
        pro = _prolong_lin if linear else _prolong
        x = x + pro(ec, levels.dims[level + 1]).to(dtype)

    js = getattr(A, "jacobi_sweep", None)
    if post and js is not None:
        # the last sweep writes the requested output dtype itself
        for _ in range(post - 1):
            x = smooth(x, b, omega)
        if rdot:
            return A.jacobi_sweep_dot(x, b, omega, out_dtype=out_dtype)
        return js(x, b, omega, out_dtype=out_dtype)
    for _ in range(post):
        x = smooth(x, b, omega)
    x = x if out_dtype is None else x.to(out_dtype)
    return (x, None) if rdot else x


def mg_preconditioner(op, *, nu: int = 2, min_size: int = 4,
                      coarse_iters: int = 40, cycle: str = "w",
                      transfers: str = "pwc", dtype=None,
                      return_rdot: bool = False) -> Callable:
    """Return ``M(r) -> z ~= A^{-1} r`` (one V or W cycle; flat or
    grid-shaped ``r``; for a ``Stencil2D`` also a stack of either, one
    independent system each), or with ``return_rdot`` ``M(r) -> (z, r · z)``
    for ``cg(precond_dot=...)`` (one system only).

    ``dtype``: the cycle's arithmetic dtype (the residual is cast in, the
    correction cast back to ``r.dtype``).  ``None`` = auto: bf16 when the
    level-0 f32 grid exceeds ``_BF16_CYCLE_BYTES``, else ``r.dtype``."""
    levels = plan(op, nu=nu, min_size=min_size, coarse_iters=coarse_iters,
                  cycle=cycle, transfers=transfers)
    dims = levels.dims[0]
    nd = len(dims)
    if dtype is None:
        cycle_dtype = (torch.bfloat16 if 4 * math.prod(dims) > _BF16_CYCLE_BYTES
                       else None)   # None = follow the input dtype
    else:
        cycle_dtype = dtype

    def run(r: torch.Tensor, rdot: bool):
        g = r if tuple(r.shape[-nd:]) == dims else r.reshape(*r.shape[:-1],
                                                             *dims)
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
