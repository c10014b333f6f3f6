"""Communication-avoiding s-step GMRES with a Newton basis (port of the
JAX package's ``solvers/castep.py``, single-device forms).

Each restart cycle builds the whole Krylov block first,
``k_0 = r``, ``k_{j+1} = (A - theta_j I) k_j``, and orthogonalizes once:
the shifted recurrence gives the columns of ``A K_s`` explicitly, so the
projected least squares is one tall-skinny QR of an ``(n, s)`` panel
(``reductions="column"``) or one ``(s+1, s+1)`` Gram matrix
(``reductions="single"``).  Chebyshev points of ``[lmin, lmax]`` in Leja
order keep the basis well conditioned to s of about 12 to 20.  The panel
and Gram products run in full f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    KrylovResult,
    _sharded_b,
    make_reducer,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import span


def chebyshev_shifts(lmin: float, lmax: float, s: int) -> list:
    """Chebyshev points of [lmin, lmax] in Leja order (max-min spread):
    the standard Newton-basis shifts for a real positive spectrum."""
    pts = [0.5 * (lmax + lmin)
           + 0.5 * (lmax - lmin) * math.cos((2 * k + 1) * math.pi / (2 * s))
           for k in range(s)]
    ordered = [max(pts)]
    rest = [p for p in pts if p != ordered[0]]
    while rest:
        nxt = max(rest, key=lambda p: sum(
            math.log(abs(p - q) + 1e-300) for q in ordered))
        ordered.append(nxt)
        rest.remove(nxt)
    return ordered


def ca_gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    s: int = 8,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    shifts: Optional[Sequence[float]] = None,
    lmin: Optional[float] = None,
    lmax: Optional[float] = None,
    reductions: str = "column",
    fixed_cycles: bool = False,
    axis_name=None,
    mesh=None,
) -> KrylovResult:
    """Restarted s-step GMRES for one system ``b`` of shape ``(n,)``.
    ``shifts`` (length >= s) or the spectral interval ``[lmin, lmax]``
    supply the Newton basis; without both the basis is monomial (keep
    ``s <= 4``).

    ``reductions``: ``"column"`` scales each basis column by its norm and
    solves the panel least squares by QR; ``"single"`` builds the basis
    with the capacity scaling only and takes everything, the residual norm
    included, from one Gram matrix per cycle (conditioning squared: f64,
    or small ``s`` in f32).  ``fixed_cycles`` takes ``ceil(maxiter / s)``
    cycles with masked updates and no host read.  Otherwise the loop test
    is read on the host once per cycle (``KrylovResult.syncs``).

    ``axis_name``/``mesh``: a sharded solve.  ``b`` is then a flattened
    shard stack ``(shards, n)``, each shard builds its rows of the basis,
    every scalar is ``(shards,)``, and the norms and Gram matrices are
    local partials followed by the mesh's ``psum``; for ``"column"`` the
    panel least squares becomes the Cholesky of the ``psum``-reduced
    ``(s, s)`` Gram of ``A K`` (the distributed rows admit no panel QR),
    as in JAX."""
    if reductions not in ("column", "single"):
        raise ValueError(f"unknown reductions mode {reductions!r}")
    sharded = _sharded_b(b, axis_name, mesh)
    psum = make_reducer(axis_name, mesh)
    dtype, dev = b.dtype, b.device
    if sharded:
        def pnorm2(v):
            return psum(torch.sum(v * v, dim=-1))

        def dot(u, v):
            return torch.sum(u * v, -1)

        def gvec(M, v):                       # M v, batched over shards
            return full_matmul(M, v[..., None])[..., 0]

        def comb(y, V):                       # sum_j y_j V_j, per shard
            return full_matmul(y[:, None, :], V)[:, 0]

        def trace(M):
            return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)

        def col(t):
            return t[:, None]
    else:
        def pnorm2(v):
            return torch.sum(v * v)

        dot, gvec, comb, trace = torch.dot, full_matmul, full_matmul, torch.trace

        def col(t):
            return t
    if shifts is None:
        if lmin is not None and lmax is not None:
            shifts = chebyshev_shifts(lmin, lmax, s)
        else:
            shifts = [0.0] * s
    shifts = [float(t) for t in list(shifts)[:s]]
    theta = torch.tensor(shifts, dtype=dtype, device=dev)

    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x)
    beta0 = torch.sqrt(pnorm2(r0))
    tol = torch.clamp_min(rtol * beta0, atol)
    tiny = torch.finfo(dtype).tiny
    eps = torch.finfo(dtype).eps
    # logarithmic-capacity column scaling of the reduction-free basis
    capacity = ((lmax - lmin) / 4.0
                if lmin is not None and lmax is not None and lmax > lmin
                else 1.0)
    eye_s = torch.eye(s, dtype=dtype, device=dev)

    def chol_solve(Gm, c):
        jitter = eps * (trace(Gm) / s + 1.0)
        ch, info = torch.linalg.cholesky_ex(Gm + jitter[..., None, None]
                                            * eye_s)
        return torch.cholesky_solve(c[..., None], ch)[..., 0], info

    def commit(active, running, x, iters, rnorm, converged, x_new,
               rnorm_new):
        return (torch.where(col(active), x_new, x),
                torch.where(running, iters + s, iters),
                torch.where(active, rnorm_new, rnorm),
                converged | (active & (rnorm_new <= tol)))

    def cycle_single(x, iters, rnorm, converged):
        r = b - matvec(x)
        W = [r]
        for th in shifts:
            W.append((matvec(W[-1]) - th * W[-1]) / capacity)
        W = torch.stack(W, dim=-2)                   # ([shards,] s+1, n)
        G = psum(full_matmul(W, W.transpose(-2, -1)))
        # A w_j = capacity w_{j+1} + theta_j w_j  =>  C = B W
        B = (capacity * torch.eye(s, s + 1, dtype=dtype, device=dev).roll(
            1, dims=1) + theta[:, None] * torch.eye(s, s + 1, dtype=dtype,
                                                    device=dev))
        Gc = full_matmul(full_matmul(B, G), B.T)
        c = gvec(B, G[..., 0])
        y, info = chol_solve(Gc, c)
        x_new = x + comb(y, W[..., :s, :])
        rsq = G[..., 0, 0] - 2.0 * dot(y, c) + dot(y, gvec(Gc, y))
        rnorm_new = torch.sqrt(torch.clamp_min(rsq, 0.0))
        # a basis beyond the working precision breaks the Cholesky:
        # freeze the iterate while the count runs on to maxiter
        finite = torch.isfinite(rsq) & torch.isfinite(y).all(-1) & (info == 0)
        running = ~converged & (iters < maxiter)
        return commit(running & finite, running, x, iters, rnorm, converged,
                      x_new, rnorm_new)

    def cycle(x, iters, rnorm, converged):
        r = b - matvec(x)
        beta = torch.sqrt(pnorm2(r))
        K = [r / col(torch.clamp_min(beta, tiny))]
        sigmas = []
        for th in shifts:
            w = matvec(K[-1]) - th * K[-1]
            sigma = torch.sqrt(pnorm2(w))
            K.append(w / col(torch.clamp_min(sigma, tiny)))
            sigmas.append(sigma)
        K = torch.stack(K, dim=-2)                   # ([shards,] s+1, n)
        # A k_j = sigma_{j+1} k_{j+1} + theta_j k_j: the columns of A K_s
        C = (torch.stack(sigmas, dim=-1)[..., None] * K[..., 1:, :]
             + theta[:, None] * K[..., :s, :])
        if sharded:
            G = psum(full_matmul(C, C.transpose(-2, -1)))
            y, _ = chol_solve(G, psum(gvec(C, r)))
        else:
            q, rr = torch.linalg.qr(C.T, mode="reduced")     # (n,s),(s,s)
            diag = torch.diagonal(rr)
            safe = diag.abs() > eps * diag.abs().max()
            rr = rr + torch.diag((~safe).to(dtype))
            qtr = torch.where(safe, full_matmul(q.T, r), 0.0)
            y = torch.linalg.solve_triangular(rr, qtr[:, None],
                                              upper=True)[:, 0]
        x_new = x + comb(y, K[..., :s, :])
        res = r - comb(y, C)
        rnorm_new = torch.sqrt(pnorm2(res))
        active = ~converged & (iters < maxiter)
        return commit(active, active, x, iters, rnorm, converged, x_new,
                      rnorm_new)

    body = cycle_single if reductions == "single" else cycle
    state = (x, torch.zeros(beta0.shape, dtype=torch.int32, device=dev),
             beta0, beta0 <= tol)
    syncs = 0
    if fixed_cycles:
        for _ in range(-(-maxiter // s)):
            state = body(*state)
    else:
        while True:
            syncs += 1
            with span("krylov.sync"):
                live = bool((~state[3] & (state[1] < maxiter)).any())
            if not live:
                break
            state = body(*state)
    x, iters, rnorm, converged = state
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=beta0,
                        converged=converged, syncs=syncs)
