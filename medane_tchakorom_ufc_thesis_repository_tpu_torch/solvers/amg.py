"""Smoothed-aggregation algebraic multigrid preconditioner (port of the
JAX package's ``solvers/amg.py``, the PCGAMG analog).

Set-up derives the hierarchy from the matrix graph alone, on the host in
f64 with scipy (Vanek smoothed aggregation): strength graph, greedy
aggregation, tentative piecewise-constant P, smoothed
``P = (I - omega D^{-1} A) P_t`` with ``omega = 4 / (3 rho(D^{-1} A))``,
Galerkin ``A_{k+1} = P^T A_k P``, down to a dense coarse inverse.

The apply is a V(nu, nu) cycle with damped-Jacobi smoothing (symmetric,
the same count before and after, so the cycle is SPD and a valid ``cg``
or ``minres`` preconditioner).  Each level's operator is routed by
``core.operators.from_scipy``; P and P^T are ELL packs of their own, so
no transfer is a scatter; the coarse inverse is one full-f32 matmul.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    ELL,
    from_scipy,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import (
    coo_to_ell,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
)

__all__ = ["AMGPreconditioner", "amg_setup"]


@dataclasses.dataclass(frozen=True)
class AMGLevel:
    """One hierarchy level: the routed operator, the damped-Jacobi
    smoother diagonal (``omega / diag``), and the transfer packs."""

    op: Any               # routed operator (DIA | BSR | DenseOp | AIJ)
    dinv: torch.Tensor    # (n_k,) omega_smooth / diag(A_k)
    P: ELL                # (n_k, n_{k+1}) smoothed prolongator
    Pt: ELL               # (n_{k+1}, n_k) its transpose, its own pack


@dataclasses.dataclass(frozen=True)
class AMGPreconditioner:
    """V(nu, nu) smoothed-aggregation cycle; ``apply`` takes ``(n,)`` or
    a batch ``(k, n)`` and is usable as ``cg(..., precond=M.apply)`` or
    ``solve(..., pc="amg")``."""

    levels: Tuple[AMGLevel, ...]
    coarse_inv: torch.Tensor   # (nc, nc) dense inverse of the coarsest A
    nu: int = 1

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r)

    def _cycle(self, k: int, r: torch.Tensor) -> torch.Tensor:
        if k == len(self.levels):
            return full_matmul(r, self.coarse_inv.T)
        lvl = self.levels[k]
        x = lvl.dinv * r                       # first sweep from x = 0
        for _ in range(self.nu - 1):
            x = x + lvl.dinv * (r - lvl.op.mv(x))
        rc = lvl.Pt.mv(r - lvl.op.mv(x))
        x = x + lvl.P.mv(self._cycle(k + 1, rc))
        for _ in range(self.nu):
            x = x + lvl.dinv * (r - lvl.op.mv(x))
        return x


def _strength_csr(A, theta: float):
    """Symmetric strength-of-connection graph as a csr without diagonal:
    ``|a_ij| >= theta * sqrt(|a_ii a_jj|)``."""
    coo = A.tocoo()
    d = np.abs(A.diagonal())
    d[d == 0] = 1.0
    off = coo.row != coo.col
    strong = off & (np.abs(coo.data)
                    >= theta * np.sqrt(d[coo.row] * d[coo.col]))
    return sp.csr_matrix(
        (np.ones(int(strong.sum())), (coo.row[strong], coo.col[strong])),
        shape=A.shape)


def _aggregate(S) -> np.ndarray:
    """Greedy aggregation (Vanek phases 1 to 3) on the strength graph:
    ``agg[i] in [0, n_agg)``.  A host-side loop over rows, O(nnz)."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    count = 0
    # phase 1: an untouched seed with a fully untouched neighbourhood
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = count
            agg[nbrs] = count
            count += 1
    # phase 2: stragglers join an adjacent aggregate
    stragglers = np.flatnonzero(agg == -1)
    snapshot = agg.copy()
    for i in stragglers:
        nbrs = indices[indptr[i]:indptr[i + 1]]
        joined = nbrs[snapshot[nbrs] != -1]
        if len(joined):
            agg[i] = snapshot[joined[0]]
    # phase 3: isolated nodes become singleton aggregates
    for i in np.flatnonzero(agg == -1):
        agg[i] = count
        count += 1
    return agg


def _rho_dinv_a(A, iters: int = 20, seed: int = 0) -> float:
    """Power-iteration estimate of ``rho(D^{-1} A)`` (host f64)."""
    d = A.diagonal().astype(np.float64)
    d[d == 0] = 1.0
    v = np.random.default_rng(seed).standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    rho = 2.0
    for _ in range(iters):
        w = (A @ v) / d
        nw = np.linalg.norm(w)
        if nw == 0:
            break
        rho, v = nw, w / nw
    return float(max(rho, 1e-12))


def amg_setup(A, *, theta: float = 0.0, nu: int = 1, max_levels: int = 12,
              coarse_n: int = 256, dtype: torch.dtype = torch.float32,
              max_coarse_dense: int = 4096, device=None,
              **route_kw) -> AMGPreconditioner:
    """Build the smoothed-aggregation hierarchy for a symmetric positive
    definite ``scipy.sparse`` (or dense numpy) matrix, on ``device``
    (None: the current CUDA device).

    ``theta``: strength threshold (0: every off-diagonal is strong, right
    for M-matrices like diffusion; raise toward 0.25 for anisotropic
    problems).  ``nu``: smoothing sweeps before and after."""
    device = resolve(device)
    A = sp.csr_matrix(A).astype(np.float64)
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"amg_setup needs a square matrix, got {A.shape}")

    levels = []
    Ak = A
    while Ak.shape[0] > coarse_n and len(levels) < max_levels:
        n = Ak.shape[0]
        agg = _aggregate(_strength_csr(Ak, theta))
        nc = int(agg.max()) + 1
        if nc >= 0.9 * n:
            # no meaningful coarsening: a shallower hierarchy, as long as
            # the coarse solve below can afford this size
            break
        # tentative prolongator: piecewise constant over aggregates,
        # columns normalized (near-nullspace candidate = ones)
        sizes = np.bincount(agg, minlength=nc).astype(np.float64)
        Pt_tent = sp.csr_matrix(
            (1.0 / np.sqrt(sizes[agg]), (np.arange(n), agg)), shape=(n, nc))
        omega = 4.0 / (3.0 * _rho_dinv_a(Ak))
        d = Ak.diagonal().copy()
        d[d == 0] = 1.0
        P = (Pt_tent - omega * (sp.diags(1.0 / d) @ (Ak @ Pt_tent))).tocsr()
        P.eliminate_zeros()
        pcoo = P.tocoo()
        levels.append(AMGLevel(
            op=from_scipy(Ak, dtype=dtype, device=device, **route_kw),
            dinv=torch.from_numpy(omega / d).to(device=device, dtype=dtype),
            P=coo_to_ell(pcoo.row, pcoo.col, pcoo.data, P.shape, dtype=dtype,
                         device=device),
            Pt=coo_to_ell(pcoo.col, pcoo.row, pcoo.data,
                          (P.shape[1], P.shape[0]), dtype=dtype,
                          device=device)))
        Ak = (P.T @ (Ak @ P)).tocsr()
        Ak.eliminate_zeros()

    if Ak.shape[0] > max_coarse_dense:
        raise ValueError(
            f"AMG coarsening stalled at n={Ak.shape[0]} (> "
            f"max_coarse_dense={max_coarse_dense}): the strength graph "
            f"has too few connections to aggregate (theta={theta} too "
            "high, or the matrix is near-diagonal — use pc='jacobi')")
    if Ak.shape[0] > coarse_n:
        warnings.warn(
            f"AMG hierarchy bottomed out at n={Ak.shape[0]} > coarse_n="
            f"{coarse_n}; using a dense coarse inverse at that size",
            UserWarning, stacklevel=2)
    coarse_inv = np.linalg.pinv(Ak.toarray())
    return AMGPreconditioner(
        levels=tuple(levels),
        coarse_inv=torch.from_numpy(coarse_inv).to(device=device, dtype=dtype),
        nu=nu)
