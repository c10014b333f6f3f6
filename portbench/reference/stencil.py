"""The 2D 5-point and 3D 7-point Dirichlet Poisson operators, written out
plainly, and the relative residual that decides whether a solve is
correct.

Unknowns lie on an ``(n1, n2)`` or ``(n1, n2, n3)`` grid with zeros
outside it; ``(A u)_i = diag * u_i + off * (sum of the 2D or 3D
neighbours of i inside the grid)``.  The Poisson matrices are
``diag = 4`` or ``6`` and ``off = -1``.
"""

from __future__ import annotations

import numpy as np
import torch


def poisson_apply(u: torch.Tensor, diag: float, off: float) -> torch.Tensor:
    """``A u`` on a 2D or 3D grid, in ``u``'s dtype and on its device."""
    if u.dim() not in (2, 3):
        raise ValueError(f"a 2D or 3D grid is needed, got shape {tuple(u.shape)}")
    y = u * diag
    for axis in range(u.dim()):
        n = u.shape[axis]
        if n < 2:
            continue
        y.narrow(axis, 1, n - 1).add_(u.narrow(axis, 0, n - 1), alpha=off)
        y.narrow(axis, 0, n - 1).add_(u.narrow(axis, 1, n - 1), alpha=off)
    return y


def poisson_apply_np(u: np.ndarray, diag: float, off: float) -> np.ndarray:
    """``A u`` on a 2D or 3D NumPy grid, in f64."""
    u = np.asarray(u, np.float64)
    y = diag * u
    for axis in range(u.ndim):
        lead = [slice(None)] * u.ndim
        tail = [slice(None)] * u.ndim
        lead[axis], tail[axis] = slice(1, None), slice(None, -1)
        y[tuple(lead)] += off * u[tuple(tail)]
        y[tuple(tail)] += off * u[tuple(lead)]
    return y


def relative_residual(b: torch.Tensor, x: torch.Tensor, diag: float,
                      off: float) -> float:
    """``||b - A x|| / ||b||`` with ``b`` and ``x`` f64 grids of one shape:
    the true residual that a solve's guarantee is stated on."""
    if b.dtype != torch.float64 or x.dtype != torch.float64:
        raise ValueError(f"f64 grids are needed, got {b.dtype} and {x.dtype}")
    if b.shape != x.shape:
        raise ValueError(f"b {tuple(b.shape)} and x {tuple(x.shape)} differ")
    r = poisson_apply(x, diag, off)
    torch.sub(b, r, out=r)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
