"""Double-float iterative refinement: the 3D Poisson north-star solve
(port of the JAX package's ``solvers/refine.py``).

Each pass solves the correction problem in f32 with W-cycle-
preconditioned CG, adds the correction to a double-float (two-f32) x,
and recomputes the true residual in double-float (``solvers/df64.py``),
until ``||b - A x|| <= rtol ||b||``.  JAX runs the pass loop as one
``lax.while_loop``; here it is a Python loop over device tensors that
reads one boolean per pass and per CG iteration.  ``RefineResult``
reports the CG iterations of each pass and the number of those host
reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import cg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
    mg_preconditioner,
)


@dataclasses.dataclass
class RefineResult:
    x: object                  # f64 numpy array, or the device (hi, lo) pair
    passes: int
    rel_history: List[float]
    rnorm: float
    rnorm0: float
    converged: bool
    pcg_iters: List[int] = dataclasses.field(default_factory=list)
    syncs: int = 0             # host reads of device values


def df_northstar_fused(
    op,
    b_df=None,
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
    inner_rtol: float = 1e-5,
    pcg_maxiter: int = 40,
    nu: int = 2,
    min_size: int = 4,
    coarse_iters: int = 40,
    cycle: str = "w",
    device=None,
) -> RefineResult:
    """Double-float-refined MG-PCG solve of ``A x = b`` to ``rtol``
    relative TRUE residual.  ``b_df``: the (hi, lo) f32 pair of b; when
    None, ``b = A·1`` is built on ``device`` (None: the current CUDA
    device).  ``RefineResult.x`` is the
    device (hi, lo) pair; ``rel_history`` stays empty, as in JAX."""
    residual = df64.df_residual_for(op)
    # return_rdot: PCG's r·z comes out of the cycle's last sweep
    Md = mg_preconditioner(op, nu=nu, min_size=min_size,
                           coarse_iters=coarse_iters, cycle=cycle,
                           return_rdot=True)
    if b_df is None:
        bhi = op.mv(torch.ones(op.dims, dtype=torch.float32,
                               device=resolve(device)))
        b_df = (bhi, torch.zeros_like(bhi))
    bhi, blo = b_df
    rnorm0 = df64.scaled_norm(bhi)
    tol = rtol * rnorm0
    xhi, xlo = torch.zeros_like(bhi), torch.zeros_like(bhi)
    rhi, rnorm = bhi, rnorm0
    passes = syncs = 0
    pcg_iters: List[int] = []
    while passes < max_passes:
        syncs += 1
        if not bool(rnorm > tol):
            break
        res = cg(op.mv, rhi / rnorm, maxiter=pcg_maxiter, rtol=inner_rtol,
                 precond_dot=Md, matvec_dot=op.mv_dot)
        pcg_iters.append(res.iters)
        syncs += res.syncs
        upd = df64.df_mul_f32((res.x, torch.zeros_like(res.x)), rnorm)
        xhi, xlo = df64.df_add((xhi, xlo), upd)
        rhi, _ = residual((bhi, blo), (xhi, xlo))
        rnorm = df64.scaled_norm(rhi)
        passes += 1
    stats = torch.stack([rnorm, rnorm0]).cpu()   # one read for both
    syncs += 1
    rn, rn0 = float(stats[0]), float(stats[1])
    return RefineResult((xhi, xlo), passes, [], rn, rn0, rn <= rtol * rn0,
                        pcg_iters=pcg_iters, syncs=syncs)


def df_iterative_refinement(
    op,
    b64,
    solve_f32: Callable,
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
    b_df=None,
    return_host: bool = True,
    device=None,
) -> RefineResult:
    """Host-loop refinement with double-float residuals (the CLI's
    stacked MGPCG route).  ``solve_f32(r32 grid) -> d32`` is any f32
    device solve.  ``b64``: f64 numpy RHS, split to a df pair on
    ``device`` (None: the current CUDA device); or None with ``b_df``, a device (hi, lo) pair.
    ``return_host=False`` leaves ``x`` as the device df pair."""
    residual = df64.df_residual_for(op)
    syncs = 0
    if b_df is not None:
        bhi, blo = b_df
        dims = tuple(bhi.shape)
        rnorm0 = float(df64.scaled_norm(bhi))
        syncs += 1
    else:
        b64 = np.asarray(b64, np.float64)
        dims = b64.shape
        rnorm0 = float(np.linalg.norm(b64.ravel()))
        bhi, blo = df64.df_from_f64(b64.reshape(op.dims), device)
    if rnorm0 == 0.0:
        return RefineResult(np.zeros(dims), 0, [], 0.0, 0.0, True, syncs=syncs)
    xhi, xlo = torch.zeros_like(bhi), torch.zeros_like(blo)
    history: List[float] = []
    rhi, rnorm = bhi, rnorm0
    for p in range(max_passes + 1):
        if p > 0:
            rhi, _ = residual((bhi, blo), (xhi, xlo))
            rnorm = float(df64.scaled_norm(rhi))
            syncs += 1
        rel = rnorm / rnorm0
        history.append(rel)
        if rel <= rtol or p == max_passes:
            break
        scale = torch.tensor(rnorm, dtype=torch.float32, device=bhi.device)
        d32 = solve_f32(rhi / scale)
        upd = df64.df_mul_f32((d32, torch.zeros_like(d32)), scale)
        xhi, xlo = df64.df_add((xhi, xlo), upd)
    x = df64.df_to_f64((xhi, xlo)).reshape(dims) if return_host else (xhi, xlo)
    return RefineResult(x, len(history) - 1, history, rnorm, rnorm0,
                        history[-1] <= rtol, syncs=syncs)


def stencil3d_mv_np(nx: int, ny: int, nz: int, diag: float = 6.0,
                    off: float = -1.0):
    """Exact f64 host matvec for the 3D 7-point operator (numpy)."""

    def mv(x):
        g = np.asarray(x, np.float64).reshape(nx, ny, nz)
        y = diag * g
        y[1:] += off * g[:-1]
        y[:-1] += off * g[1:]
        y[:, 1:, :] += off * g[:, :-1, :]
        y[:, :-1, :] += off * g[:, 1:, :]
        y[:, :, 1:] += off * g[:, :, :-1]
        y[:, :, :-1] += off * g[:, :, 1:]
        return y.reshape(-1)

    return mv
