"""Krylov solvers (port of the JAX package's ``solvers/krylov.py``):
conjugate gradients in its single-device order, and restarted GMRES(m)
over a batch of independent systems.

JAX runs each iteration as a ``lax.while_loop``.  Here it is a Python
loop: the loop's test is computed on the device, in the solve's dtype,
exactly as JAX computes it, and read on the host (CG once per iteration,
GMRES once per restart cycle).  ``KrylovResult.syncs`` counts those
reads.
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


def cg(
    matvec: Callable,
    b: torch.Tensor,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
    matvec_dot: Optional[Callable] = None,
    precond_dot: Optional[Callable] = None,
) -> KrylovResult:
    """Preconditioned CG for SPD systems from the zero guess, stopping on
    the TRUE residual norm ``||r||_2 <= max(rtol * ||b||, atol)`` (PETSc's
    unpreconditioned norm type).

    ``matvec_dot``: optional fused ``p -> (A p, p · A p)``
    (``Stencil3D.mv_dot``).  ``precond_dot``: optional fused
    ``r -> (z, r · z)`` (``mg_preconditioner(op, return_rdot=True)``);
    it takes precedence over ``precond``.  ``divtol``: stop, not
    converged, once the residual exceeds ``divtol * rnorm0`` (0
    disables).  The preconditioner runs at the start of each iteration,
    so the last iteration skips a dead apply; ``beta`` and ``alpha`` are
    guarded against zero denominators as in the JAX package, so the
    iteration counts match it.
    """
    dtype = b.dtype
    r = b   # x0 = 0 => r0 = b exactly
    rs = _vdot(r, r)
    rnorm0 = torch.sqrt(rs)
    tol = torch.clamp_min(rtol * rnorm0, atol)
    div = divtol * rnorm0

    def keep_going(rs):
        keep = torch.sqrt(rs) > tol
        if divtol > 0.0:
            keep = keep & (torch.sqrt(rs) <= div)
        return bool(keep)

    x, p = torch.zeros_like(b), torch.zeros_like(b)
    rz = torch.ones((), dtype=dtype, device=b.device)
    iters = syncs = 0
    while iters < maxiter:
        syncs += 1
        if not keep_going(rs):
            break
        if precond_dot is not None:
            z, rz_loc = precond_dot(r)
            rz_new = rz_loc.to(dtype)
        else:
            z = r if precond is None else precond(r)
            rz_new = _vdot(r, z)
        if iters == 0:
            beta = torch.zeros((), dtype=dtype, device=b.device)
        else:
            nz = rz != 0
            beta = torch.where(nz, rz_new / torch.where(nz, rz, 1.0), 0.0)
        p = z + beta * p
        if matvec_dot is not None:
            ap, pap = matvec_dot(p)
        else:
            ap = matvec(p)
            pap = _vdot(p, ap)
        nz = pap != 0
        alpha = torch.where(nz, rz_new / torch.where(nz, pap, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rs = _vdot(r, r)
        rz = rz_new
        iters += 1
    rnorm = torch.sqrt(rs)
    return KrylovResult(x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0,
                        converged=rnorm <= tol, syncs=syncs)


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
