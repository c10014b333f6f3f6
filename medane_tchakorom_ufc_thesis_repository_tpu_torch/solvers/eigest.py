"""Lanczos spectral-interval estimation for SPD operators (port of the
JAX package's ``solvers/eigest.py``).

CA-GMRES's Newton basis needs the spectral interval ``[lmin, lmax]``;
user matrices carry no analytic bounds.  A fixed number of Lanczos steps
with full reorthogonalization gives the tridiagonal coefficients; the
host truncates them at the first breakdown-scale ``beta``, takes the
extreme Ritz values of the valid leading block and widens them by a
safety factor (PETSc's ``esteig`` transform).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
)

__all__ = ["lanczos_bounds", "lanczos_coeffs", "bounds_from_coeffs"]


def lanczos_coeffs(mv: Callable, v0: torch.Tensor, m: int):
    """``m`` Lanczos steps with full (two-pass classical Gram-Schmidt)
    reorthogonalization against the whole basis; returns the tridiagonal
    coefficients ``(alphas (m,), betas (m,))``.  The basis products run in
    full f32."""
    n = v0.shape[0]
    V = torch.zeros((m + 1, n), dtype=v0.dtype, device=v0.device)
    V[0] = v0
    alphas, betas = [], []
    for j in range(m):
        w = mv(V[j])
        # rows > j of V are zero: whole-basis products, as in JAX
        h = full_matmul(V, w)
        w = w - full_matmul(h, V)
        h2 = full_matmul(V, w)
        w = w - full_matmul(h2, V)
        beta = torch.sqrt(torch.sum(w * w))
        V[j + 1] = torch.where(beta > 0, w / torch.where(beta > 0, beta, 1.0),
                               w)
        alphas.append(h[j] + h2[j])
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)


def bounds_from_coeffs(alphas, betas, *, safety: float = 0.1,
                       eps: Optional[float] = None) -> Tuple[float, float]:
    """Host side: truncate at the first breakdown-scale ``beta``,
    diagonalize the valid leading tridiagonal block, return the
    safety-widened Ritz interval.  Raises ``ValueError`` when the interval
    is not positive (the operator does not look SPD)."""
    alphas = np.asarray(alphas, np.float64)
    betas = np.asarray(betas, np.float64)
    m = alphas.shape[0]
    if eps is None:
        eps = float(np.finfo(np.float64).eps)
    g = m
    scale = 0.0
    for j in range(m):
        scale = max(scale, abs(alphas[j]))
        if betas[j] <= 100.0 * eps * max(scale, 1e-300):
            g = j + 1
            break
        scale = max(scale, betas[j])
    T = np.diag(alphas[:g])
    if g > 1:
        T += np.diag(betas[: g - 1], 1) + np.diag(betas[: g - 1], -1)
    theta = np.linalg.eigvalsh(T)
    tmin, tmax = float(theta.min()), float(theta.max())
    lmin = (1.0 - safety) * tmin
    lmax = (1.0 + safety) * tmax
    if not (np.isfinite(lmin) and np.isfinite(lmax)) or lmin <= 0:
        raise ValueError(
            f"lanczos bounds: estimated interval [{lmin:.3e}, {lmax:.3e}] "
            "is not positive — the operator does not look SPD; "
            "chebyshev/ca_gmres need an SPD diagonal block (use "
            "gmres/cg, or pass eig_min/eig_max explicitly)")
    return lmin, lmax


def lanczos_bounds(mv: Callable, n: int, *, iters: int = 30, seed: int = 7,
                   safety: float = 0.1,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Tuple[float, float]:
    """Estimate the spectral interval of an SPD operator: one Lanczos
    sweep on ``device`` (None: the current CUDA device) from a seeded
    start vector, then the host-side Ritz extraction."""
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    m = max(1, min(int(iters), n))
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    v0 /= np.linalg.norm(v0)
    dt = torch.float32 if dtype is None else dtype
    alphas, betas = lanczos_coeffs(
        mv, torch.from_numpy(v0).to(device=resolve(device), dtype=dt), m)
    return bounds_from_coeffs(alphas.cpu().numpy(), betas.cpu().numpy(),
                              safety=safety, eps=float(torch.finfo(dt).eps))
