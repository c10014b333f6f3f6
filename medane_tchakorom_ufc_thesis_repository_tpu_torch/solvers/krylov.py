"""Krylov solvers (port of the JAX package's ``solvers/krylov.py``):
conjugate gradients in its single-device order, BiCGStab, MINRES, and
restarted GMRES(m), each over one system or a batch of independent
systems.

JAX runs each iteration as a ``lax.while_loop``.  Here it is a Python
loop: the loop's test is computed on the device, in the solve's dtype,
exactly as JAX computes it, and read on the host (CG, BiCGStab and MINRES
once per iteration, GMRES once per restart cycle).
``KrylovResult.syncs`` counts those reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.fused import maxpy, mdot


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solver output (the analog of KSPGetIterationNumber /
    KSPGetResidualNorm / KSPGetConvergedReason)."""

    x: torch.Tensor
    # iterations (matvecs) taken: an int, or for a batch of systems a
    # tensor with one count per system, as are the norms and the flag
    iters: Union[int, torch.Tensor]
    resnorm: torch.Tensor      # final recurrence residual norm
    resnorm0: torch.Tensor     # initial residual norm used by the test
    converged: torch.Tensor    # bool
    syncs: int = 0             # host reads of device values


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _batch_ops(batched: bool):
    """``(dot, col, commit)`` of a solve over one system or a batch.  One
    system: ``b`` of any shape, scalars 0-dim.  A batch: ``b`` is
    ``(k, n)``, every scalar of the recurrence is ``(k,)``, ``col`` makes
    one broadcast against the vectors, and ``commit(live, new, old)``
    keeps the old state of the systems whose loop test has failed (what
    ``jax.vmap`` of a ``while_loop`` does)."""
    if not batched:
        return _vdot, (lambda s: s), (lambda live, new, old: new)

    def commit(live, new, old):
        return torch.where(live if new.dim() == 1 else live[:, None], new, old)

    return _rowdot, (lambda s: s[:, None]), commit


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den`` is nonzero, else 0."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)


def _entry_norms(r, rnorm0, rtol, atol, dot):
    """``(rs, rnorm0, tol)`` of the residual ``r`` at entry."""
    rs = dot(r, r)
    rn0 = torch.sqrt(rs) if rnorm0 is None else torch.as_tensor(
        rnorm0, dtype=r.dtype, device=r.device).expand(rs.shape)
    return rs, rn0, torch.clamp_min(rtol * rn0, atol)


def _start(matvec, b, x0, rnorm0, rtol, atol, dot):
    """``(x, r, rs, rnorm0, tol)`` at entry: ``x0 = None`` is the zero
    guess, whose residual is ``b`` exactly (no matvec)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x0)
    return (x, r) + _entry_norms(r, rnorm0, rtol, atol, dot)


def _count(iters, live, step: int, batched: bool):
    return iters + step * live.to(torch.int32) if batched else iters + step


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0=None,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
    matvec_dot: Optional[Callable] = None,
    precond_dot: Optional[Callable] = None,
    matvec_axpy_dot: Optional[Callable] = None,
    batched: bool = False,
) -> KrylovResult:
    """Preconditioned CG for SPD systems, stopping on the TRUE residual
    norm ``||r||_2 <= max(rtol * rnorm0, atol)`` (PETSc's unpreconditioned
    norm type); ``rnorm0`` defaults to ``||b - A x0||``.

    ``batched``: ``b`` (and ``x0``) are ``(k, n)``, ``matvec`` and
    ``precond`` map ``(k, n)`` arrays, and the ``k`` systems iterate
    together, each frozen once its own test fails; counts, norms and the
    flag come back per system.  Otherwise ``b`` is one system of any
    shape (a grid, for the stencils).

    ``matvec_dot``: optional fused ``p -> (A p, p · A p)``
    (``Stencil3D.mv_dot``).  ``precond_dot``: optional fused
    ``r -> (z, r · z)`` (``mg_preconditioner(op, return_rdot=True)``);
    it takes precedence over ``precond``.  ``matvec_axpy_dot``: optional
    fused ``(z, p, beta) -> (p', A p', p' · A p')`` with ``p' = z + beta p``
    (``Stencil3D.axpy_mv_dot``): the direction update rides the matvec's
    pass; it takes precedence over ``matvec_dot`` for the direction
    matvec, and serves one system only.  ``beta`` reaches it as a 0-d
    tensor on the device: the hook adds no host read.  ``divtol``: stop, not
    converged, once the residual exceeds ``divtol * rnorm0`` (0
    disables).  The preconditioner runs at the start of each iteration,
    so the last iteration skips a dead apply; ``beta`` and ``alpha`` are
    guarded against zero denominators as in the JAX package, so the
    iteration counts match it.
    """
    if batched and matvec_axpy_dot is not None:
        raise ValueError("matvec_axpy_dot serves one system, not a batch")
    dot = _batch_ops(batched)[0]
    x, r, rs, rn0, tol = _start(matvec, b, x0, rnorm0, rtol, atol, dot)
    s = PCGState(x=x, r=r, p=torch.zeros_like(b), rs=rs,
                 rz=torch.ones_like(rs))
    iters = torch.zeros_like(rs, dtype=torch.int32) if batched else 0
    trips = syncs = 0
    while trips < maxiter:
        live = pcg_live(s.rs, tol, rn0, divtol)
        syncs += 1
        if not bool(live.any() if batched else live):
            break
        pcg_iteration(s, trips == 0, live, matvec=matvec, precond=precond,
                      precond_dot=precond_dot, matvec_dot=matvec_dot,
                      matvec_axpy_dot=matvec_axpy_dot, batched=batched)
        iters = _count(iters, live, 1, batched)
        trips += 1
    rnorm = torch.sqrt(s.rs)
    return KrylovResult(x=s.x, iters=iters, resnorm=rnorm, resnorm0=rn0,
                        converged=rnorm <= tol, syncs=syncs)


@dataclasses.dataclass
class PCGState:
    """The state PCG carries from one iteration to the next."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor       # r · r
    rz: torch.Tensor       # r · z of the last iteration


def pcg_live(rs, tol, rn0, divtol: float) -> torch.Tensor:
    """CG's loop test on the device: the residual is above ``tol`` and,
    when ``divtol > 0``, not above ``divtol * rn0``."""
    live = torch.sqrt(rs) > tol
    if divtol > 0.0:
        live = live & (torch.sqrt(rs) <= divtol * rn0)
    return live


def pcg_iteration(s: PCGState, first, live=None, *, matvec, precond=None,
                  precond_dot=None, matvec_dot=None, matvec_axpy_dot=None,
                  batched: bool = False, in_place: bool = False) -> None:
    """One iteration of ``cg`` on the state ``s``, which it updates: the
    body of ``cg``'s loop and of the north-star's CUDA graph
    (``solvers/refine.py``), the same operations in the same order.

    ``first``: the first iteration, where ``beta = 0``; a bool, or a 0-d
    bool tensor on the device (a graph replays one body for every
    iteration), where ``torch.where`` selects the same +0.  ``live``: the
    systems of a batch that iterate (``batched`` only).  ``in_place``
    (one system): x, r and p are written into their own storage, rs and
    rz copied into theirs, so that a graph's state stays in static
    buffers; the values are those of the other form to the bit."""
    if in_place and (batched or matvec_axpy_dot is not None):
        raise ValueError("in_place serves one system without matvec_axpy_dot")
    dtype = s.r.dtype
    dot, col, commit = _batch_ops(batched)
    if precond_dot is not None:
        z, rz_loc = precond_dot(s.r)
        rz_new = rz_loc.to(dtype)
    else:
        z = s.r if precond is None else precond(s.r)
        rz_new = dot(s.r, z)
    if isinstance(first, torch.Tensor):
        beta = torch.where(first, torch.zeros_like(s.rz),
                           _ratio(rz_new, s.rz))
    else:
        beta = torch.zeros_like(s.rz) if first else _ratio(rz_new, s.rz)
    if matvec_axpy_dot is not None:
        p_new, ap, pap = matvec_axpy_dot(z, s.p, beta)
        pap = pap.to(dtype)
    else:
        p_new = torch.add(z, col(beta) * s.p, out=s.p if in_place else None)
        if matvec_dot is not None:
            ap, pap = matvec_dot(p_new)
        else:
            ap = matvec(p_new)
            pap = dot(p_new, ap)
    alpha = col(_ratio(rz_new, pap))
    if in_place:
        torch.sub(s.r, alpha * ap, out=s.r)
        torch.add(s.x, alpha * p_new, out=s.x)
        s.rs.copy_(dot(s.r, s.r))
        s.rz.copy_(rz_new)
        return
    r_new = s.r - alpha * ap
    s.x = commit(live, s.x + alpha * p_new, s.x)
    s.p = commit(live, p_new, s.p)
    s.rs = commit(live, dot(r_new, r_new), s.rs)
    s.r = commit(live, r_new, s.r)
    s.rz = commit(live, rz_new, s.rz)


def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0=None,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
    batched: bool = False,
) -> KrylovResult:
    """BiCGStab for general systems (the PETSc KSPBCGS analog).  ``iters``
    counts matvecs, two per step.  ``precond``: optional RIGHT
    preconditioner: the recurrence runs on ``A M`` and maps back at exit,
    so the test sees the true residual.  A breakdown (``rho``, ``rhat·v``
    or ``t·t`` zero) freezes the iterate and ends the solve, reported as
    not converged.  ``batched`` as in ``cg``."""
    dot, col, commit = _batch_ops(batched)
    amv = matvec if precond is None else (lambda v: matvec(precond(v)))
    x0_, r, rs, rn0, tol = _start(matvec, b, x0, rnorm0, rtol, atol, dot)
    rhat = r                 # fixed shadow vector
    y, p, v = torch.zeros_like(b), torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = torch.ones_like(rs)
    broke = torch.zeros_like(rs, dtype=torch.bool)
    iters = torch.zeros_like(rs, dtype=torch.int32) if batched else 0
    trips = syncs = 0
    while trips < maxiter:
        live = (torch.sqrt(rs) > tol) & ~broke
        if divtol > 0.0:
            live = live & (torch.sqrt(rs) <= divtol * rn0)
        syncs += 1
        if not bool(live.any()):
            break
        rho_new = dot(rhat, r)
        ok_rho = rho_new.abs() > 0
        beta = torch.where(
            ok_rho & (rho.abs() > 0) & (omega.abs() > 0),
            (rho_new / torch.where(rho.abs() > 0, rho, 1.0))
            * (alpha / torch.where(omega.abs() > 0, omega, 1.0)), 0.0)
        p_new = r + col(beta) * (p - col(omega) * v)
        v_new = amv(p_new)
        rhv = dot(rhat, v_new)
        ok_a = rhv.abs() > 0
        alpha_new = torch.where(ok_a, rho_new / torch.where(ok_a, rhv, 1.0),
                                0.0)
        s = r - col(alpha_new) * v_new
        t = amv(s)
        ts, tt, ss = dot(t, s), dot(t, t), dot(s, s)
        ok_w = tt > 0
        omega_new = torch.where(ok_w, ts / torch.where(ok_w, tt, 1.0), 0.0)
        y_new = y + col(alpha_new) * p_new + col(omega_new) * s
        r_new = s - col(omega_new) * t
        # ||r||^2 from the dots already taken
        rs_new = torch.clamp_min(
            torch.where(ok_w, ss - omega_new * ts, ss), 0.0)
        broke_new = broke | ~ok_rho | ~ok_a | ~ok_w
        rs_new = torch.where(broke_new, rs, rs_new)
        y, r, p, v = (commit(live, y_new, y), commit(live, r_new, r),
                      commit(live, p_new, p), commit(live, v_new, v))
        rho, alpha, omega = (commit(live, rho_new, rho),
                             commit(live, alpha_new, alpha),
                             commit(live, omega_new, omega))
        rs, broke = commit(live, rs_new, rs), commit(live, broke_new, broke)
        iters = _count(iters, live, 2, batched)
        trips += 2
    x = x0_ + (y if precond is None else precond(y))
    rnorm = torch.sqrt(rs)
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=rn0,
                        converged=rnorm <= tol, syncs=syncs)


def minres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0=None,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
    batched: bool = False,
) -> KrylovResult:
    """MINRES for symmetric, possibly indefinite systems (the PETSc
    KSPMINRES analog): Paige-Saunders Lanczos and Givens recurrences, one
    matvec per iteration.  ``precond``: optional SPD preconditioner; the
    recurrence residual, and so the test, is then ``||r||_M``.  An
    indefinite ``M`` freezes the solve, reported as not converged.
    ``batched`` as in ``cg``."""
    dot, col, commit = _batch_ops(batched)
    M = (lambda v: v) if precond is None else precond
    eps = torch.finfo(b.dtype).eps
    x = torch.zeros_like(b) if x0 is None else x0
    r1 = b if x0 is None else b - matvec(x0)
    y = M(r1)
    beta1sq, rtrue0sq = dot(r1, y), dot(r1, r1)
    # r'Mr <= 0 with a nonzero residual: M is not SPD
    broke = (beta1sq <= 0) & (rtrue0sq > 0)
    beta1 = torch.sqrt(torch.clamp_min(beta1sq, 0.0))
    rn0 = beta1 if rnorm0 is None else torch.as_tensor(
        rnorm0, dtype=b.dtype, device=b.device).expand(beta1.shape)
    tol = torch.clamp_min(rtol * rn0, atol)

    zero = torch.zeros_like(beta1)
    r2, w, w2 = r1, torch.zeros_like(b), torch.zeros_like(b)
    oldb, beta, dbar, epsln, phibar = zero, beta1, zero, zero, beta1
    cs, sn = -torch.ones_like(beta1), zero
    iters = torch.zeros_like(beta1, dtype=torch.int32) if batched else 0
    trips = syncs = 0
    while trips < maxiter:
        live = (phibar > tol) & ~broke
        if divtol > 0.0:
            live = live & (phibar <= divtol * rn0)
        syncs += 1
        if not bool(live.any()):
            break
        # Lanczos step in the M inner product
        ok_b = beta > 0
        safe_b = torch.where(ok_b, beta, 1.0)
        v = y / col(safe_b)
        yk = matvec(v)
        yk = yk - col(torch.where(
            oldb > 0, beta / torch.where(oldb > 0, oldb, 1.0), 0.0)) * r1
        alfa = dot(v, yk)
        yk = yk - col(alfa / safe_b) * r2
        yn = M(yk)
        betasq = dot(yk, yn)
        ok_m = betasq >= 0
        beta_n = torch.sqrt(torch.where(ok_m, betasq, 0.0))
        # Givens QR of the tridiagonal, right-hand-side update
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta_n * beta_n), eps)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        # an M breakdown zeroed beta_n: keep the estimate as it was
        phibar_n = torch.where(ok_m, (sn_n * phibar).abs(), phibar)
        # solution update (three-term w recurrence)
        wn = (v - col(epsln) * w2 - col(delta) * w) / col(gamma)
        x = commit(live, x + col(phi) * wn, x)
        r1, r2, y = commit(live, r2, r1), commit(live, yk, r2), commit(
            live, yn, y)
        w2, w = commit(live, w, w2), commit(live, wn, w)
        oldb, beta = commit(live, beta, oldb), commit(live, beta_n, beta)
        dbar, epsln = commit(live, dbar_n, dbar), commit(live, epsln_n, epsln)
        phibar = commit(live, phibar_n, phibar)
        cs, sn = commit(live, cs_n, cs), commit(live, sn_n, sn)
        broke = commit(live, broke | ~ok_b | ~ok_m, broke)
        iters = _count(iters, live, 1, batched)
        trips += 1
    return KrylovResult(x=x, iters=iters, resnorm=phibar, resnorm0=rn0,
                        converged=(phibar <= tol) & ~broke, syncs=syncs)


# ---------------------------------------------------------------------------
# GMRES(m)
# ---------------------------------------------------------------------------

def _norms(v: torch.Tensor) -> torch.Tensor:
    """The 2-norm of each system's vector (rows of ``v``)."""
    return torch.linalg.vector_norm(v, dim=-1)


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 30,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0=None,
    orthog: str = "cgs2",
    fixed_cycles: bool = False,
    stag_tol: float = 0.0,
    basis_dtype: Optional[torch.dtype] = None,
    divtol: float = 1e5,
) -> KrylovResult:
    """Restarted GMRES with classical Gram-Schmidt and Givens least squares
    (the JAX ``krylov.gmres``), for a batch of independent systems.

    ``b`` is ``(batch, n)``, and ``matvec`` maps a ``(batch, n)`` array to
    ``A_k x_k`` for each system; a ``(n,)`` ``b`` is one system with an
    unbatched ``matvec``.  The JAX solver runs a batch as ``jax.vmap`` of
    its ``while_loop``: a system whose loop test has failed keeps its
    state while the others iterate.  So here, in each restart cycle, every
    system whose test holds (not converged, not diverged, iterations left)
    takes the cycle and every other keeps its ``x``, counts and norms; and
    within a cycle the ``m`` Arnoldi steps run unconditionally, masked per
    system as in JAX.  The test is read on the host once before each
    restart cycle after the first (the first would change nothing: a
    cycle taken by no system leaves every state as it was), and not after
    ``ceil(maxiter / m)`` cycles, when it must fail.  ``fixed_cycles``
    takes that many cycles with no read and no freezing (JAX's lockstep
    ``fori_loop``).

    ``orthog``: ``"cgs"`` one classical Gram-Schmidt pass, ``"cgs2"`` two.
    Each projection ``h = V w`` is kernel F (``ops.fused.mdot``), each
    update ``w - V^T h`` and the solution update ``x + V[:m]^T y`` kernel G
    (``ops.fused.maxpy``).  ``basis_dtype`` stores the basis narrower
    (``torch.bfloat16``); its dots and every recurrence stay in ``b``'s
    dtype.  ``rnorm0`` pins the test's reference norm (default
    ``||b - A x0||`` per system); convergence is ``||r|| <= max(rtol *
    rnorm0, atol)`` on the Givens estimate, or a happy breakdown (the new
    direction's norm under ``eps * ||hcol||``).  ``stag_tol`` stops, as
    converged, a system whose true residual falls by less than that
    fraction over a restart cycle; ``divtol`` stops, not converged, one
    whose residual exceeds ``divtol * rnorm0``.
    """
    if orthog not in ("cgs", "cgs2"):
        raise ValueError(f"unknown orthog {orthog!r}")
    if b.dim() == 1:
        one = matvec
        res = gmres(lambda v: one(v[0])[None], b[None],
                    None if x0 is None else x0[None], restart=restart,
                    maxiter=maxiter, rtol=rtol, atol=atol, rnorm0=rnorm0,
                    orthog=orthog, fixed_cycles=fixed_cycles,
                    stag_tol=stag_tol, basis_dtype=basis_dtype,
                    divtol=divtol)
        return KrylovResult(x=res.x[0], iters=res.iters[0],
                            resnorm=res.resnorm[0], resnorm0=res.resnorm0[0],
                            converged=res.converged[0], syncs=res.syncs)
    if b.dim() != 2:
        raise ValueError(f"b must be (batch, n) or (n,), got {tuple(b.shape)}")
    nsys, n = b.shape
    dtype, dev = b.dtype, b.device
    # a cycle's Arnoldi steps run unconditionally (masked when done), so a
    # restart longer than the budget would only burn work on frozen state
    m = max(1, min(restart, maxiter))
    vdtype = dtype if basis_dtype is None else basis_dtype
    eps = torch.finfo(dtype).eps

    # x0 = 0 => r0 = b exactly: skip the initial matvec
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b if x0 is None else b - matvec(x0)
    beta0 = _norms(r0)
    rn0 = beta0 if rnorm0 is None else torch.as_tensor(
        rnorm0, dtype=dtype, device=dev).expand(nsys)
    tol = torch.clamp_min(rtol * rn0, atol)

    # the basis, stored (m+1, batch, n): row j of every system is one
    # contiguous (batch, n) array, and kernels F and G read its
    # (batch, m+1, n) view in place.  Rows past j+1 are never read in
    # step j, so the basis needs no zeroing.
    Vs = torch.empty((m + 1, nsys, n), dtype=vdtype, device=dev)
    V = Vs.permute(1, 0, 2)

    def cycle(x, iters, rnorm, converged, beta_prev, diverged):
        r = b - matvec(x)
        beta = _norms(r)
        if stag_tol > 0.0:
            # true-residual stagnation between restart cycles (the
            # reference's MyConvergeTest), reported as converged
            converged = converged | (beta > beta_prev * (1.0 - stag_tol))
        if divtol > 0.0:
            diverged = diverged | (beta > divtol * rn0)
        Vs[0] = torch.where(beta[:, None] > 0, r / beta[:, None], r)
        H = torch.zeros((nsys, m + 1, m), dtype=dtype, device=dev)
        # cs=1/sn=0 make unapplied rotation slots the identity
        cs = torch.ones((nsys, m), dtype=dtype, device=dev)
        sn = torch.zeros((nsys, m), dtype=dtype, device=dev)
        g = torch.zeros((nsys, m + 1), dtype=dtype, device=dev)
        g[:, 0] = beta
        for j in range(m):
            active = ~converged & (iters < maxiter)
            w = matvec(Vs[j].to(dtype))
            # classical Gram-Schmidt against the j+1 live rows
            h = mdot(V, w, j + 1)
            w = maxpy(V, -h, w, j + 1)
            if orthog == "cgs2":
                h2 = mdot(V, w, j + 1)
                w = maxpy(V, -h2, w, j + 1)
                h = h + h2
            hj1 = _norms(w)
            pos = hj1 > 0
            vnext = torch.where(pos[:, None],
                                w / torch.where(pos, hj1, 1.0)[:, None], w)
            hcol = h
            hcol[:, j + 1] = hj1
            # happy breakdown: against ||A v_j|| = ||hcol||, not beta
            happy = hj1 <= eps * _norms(hcol)
            # the accumulated rotations; slots >= j are the identity
            for i in range(j):
                hi, hi1 = hcol[:, i], hcol[:, i + 1]
                t1 = cs[:, i] * hi + sn[:, i] * hi1
                t2 = -sn[:, i] * hi + cs[:, i] * hi1
                hcol[:, i] = t1
                hcol[:, i + 1] = t2
            # the new rotation, annihilating hcol[j+1]
            a_, b_ = hcol[:, j], hcol[:, j + 1]
            denom = torch.sqrt(a_ * a_ + b_ * b_)
            pos = denom > 0
            safe = torch.where(pos, denom, 1.0)
            c_new = torch.where(pos, a_ / safe, 1.0)
            s_new = torch.where(pos, b_ / safe, 0.0)
            hcol[:, j] = denom
            hcol[:, j + 1] = 0.0
            gj = g[:, j]
            g_new = g.clone()
            g_new[:, j] = c_new * gj
            g_new[:, j + 1] = -s_new * gj
            rnorm_new = g_new[:, j + 1].abs()
            # masked commit: a frozen system keeps what it had (row j+1
            # of the JAX basis and column j of its H start at zero)
            Vs[j + 1] = torch.where(active[:, None], vnext, 0.0)
            H[:, :, j] = torch.where(active[:, None], hcol, 0.0)
            cs[:, j] = torch.where(active, c_new, 1.0)
            sn[:, j] = torch.where(active, s_new, 0.0)
            g = torch.where(active[:, None], g_new, g)
            iters = torch.where(active, iters + 1, iters)
            rnorm = torch.where(active, rnorm_new, rnorm)
            converged = converged | (active & ((rnorm_new <= tol) | happy))
        # back substitution on the rotated, upper-triangular H; untaken
        # columns (zero diagonal) become the identity with y = 0 there
        R = H[:, :m, :]
        safe = torch.diagonal(R, dim1=1, dim2=2).abs() > 0
        R = R + torch.diag_embed((~safe).to(dtype))
        y = torch.linalg.solve_triangular(
            R, torch.where(safe, g[:, :m], 0.0)[:, :, None], upper=True)
        x_new = maxpy(V, F.pad(y[:, :, 0], (0, 1)), x, m)
        return x_new, iters, rnorm, converged, beta, diverged

    # (x, iters, rnorm, converged, beta_prev, diverged) of every system
    state = (x, torch.zeros(nsys, dtype=torch.int32, device=dev), beta0,
             beta0 <= tol, torch.full((nsys,), float("inf"), dtype=dtype,
                                      device=dev),
             torch.zeros(nsys, dtype=torch.bool, device=dev))
    syncs = 0
    for c in range(-(-maxiter // m)):
        if fixed_cycles:
            state = cycle(*state)
            continue
        x, iters, _, converged, _, diverged = state
        live = ~(converged | diverged) & (iters < maxiter)
        if c > 0:
            syncs += 1
            if not bool(live.any()):
                break
        state = tuple(torch.where(live.view(-1, *[1] * (old.dim() - 1)),
                                  new, old)
                      for new, old in zip(cycle(*state), state))
    x, iters, rnorm, converged, _, _ = state
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=rn0,
                        converged=converged, syncs=syncs)
