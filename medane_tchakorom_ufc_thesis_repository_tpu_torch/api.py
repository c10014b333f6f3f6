"""One-call solve API for users arriving from scipy.

``solve(A, b)`` takes a ``scipy.sparse`` (or dense numpy) matrix, routes
its pattern to the operator suited to the card (banded -> DIA, blockable
-> BSR, small unstructured -> dense, anything else -> AIJ, a CSR
product), builds the preconditioner, runs the requested Krylov solver on
the device and checks the result on the host in f64 against the input
matrix.  ``prepare(A)`` does the routing and the preconditioner set-up
once and returns a handle whose ``.solve(b)`` reuses them for many
right-hand sides; ``lstsq(A, b)`` is the least-squares counterpart for
rectangular or inconsistent systems.

    >>> from medane_tchakorom_ufc_thesis_repository_tpu_torch import solve
    >>> x, info = solve(A, b, rtol=1e-8, pc="bjacobi")
    >>> info["converged"], info["iters"], info["rel_residual"]

Port of the JAX package's ``api.py`` with the same options, errors and
``info`` keys, and one more keyword, ``device`` (None: the current CUDA
device; ``"cpu"`` runs the kernels' plain versions on the host).  The
solvers run eagerly, so there is no compiled-program cache to keep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    from_scipy,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.bjacobi import (
    block_jacobi_from_scipy,
)

__all__ = ["solve", "prepare", "PreparedSolver", "lstsq", "is_symmetric"]


def is_symmetric(A, *, rtol: float = 1e-12) -> bool:
    """Host-side symmetry check on a scipy matrix, pattern and values:
    ``max|A - A^T| <= rtol * max|A|``."""
    A = sp.csr_matrix(A)
    d = (A - A.T).tocoo()
    if d.nnz == 0:
        return True
    amax = float(np.abs(A.data).max()) if A.nnz else 0.0
    return bool(np.abs(d.data).max() <= rtol * amax)


def _auto_method(A, assume_a: Optional[str]) -> str:
    """Resolve ``method="auto"``.  ``assume_a`` (the ``scipy.linalg.solve``
    convention) is the user's certificate: "pos" -> cg, "sym" -> minres,
    "gen" -> gmres.  Without one, a host symmetry check picks minres for
    symmetric matrices (right for the whole class; no cheap host test
    certifies positive definiteness) and gmres otherwise."""
    if assume_a is not None:
        return {"pos": "cg", "sym": "minres", "gen": "gmres"}[assume_a]
    return "minres" if is_symmetric(A) else "gmres"


def _auto_pc(A, op, method: str) -> str:
    """"bjacobi" when the routing found block structure (a BSR operator),
    "jacobi" when the diagonal is fully nonzero, else "none".  For minres
    the preconditioner must be SPD even when A is indefinite: jacobi only
    on a strictly positive diagonal, and never bjacobi."""
    d = A.diagonal()
    if method == "minres":
        return "jacobi" if bool((d > 0).all()) else "none"
    if type(op).__name__.startswith("BSR"):
        return "bjacobi"
    if bool((d != 0).all()):
        return "jacobi"
    return "none"


class PreparedSolver:
    """Operator-bound solver handle: the KSPSetOperators-once,
    KSPSolve-many lifecycle.  Routing, the preconditioner's factorization
    (bjacobi inverses, the AMG hierarchy) and spectral estimation happen
    once in ``prepare``; every ``.solve(b)`` is the device solve and the
    host residual check."""

    def __init__(self, *, A, op, pc_op, method, pc, rtol, atol, maxiter,
                 restart, s, dt, device, bounds=None):
        self._A = A
        self._op = op
        self._pc_op = pc_op
        self._bounds = bounds
        self.method = method
        self.pc = pc
        self._cfg = (rtol, atol, maxiter, restart, s)
        self._dt = dt
        self._device = device

    @property
    def operator(self) -> str:
        """Name of the routed device representation."""
        return type(self._op).__name__

    def _run(self, b, x0, batched: bool):
        rtol, atol, maxiter, restart, _ = self._cfg
        op, pc_op = self._op, self._pc_op
        if self.pc == "none":
            M = None
        elif self.pc == "jacobi":
            M = lambda v: pc_op * v   # noqa: E731
        else:                         # bjacobi, amg
            M = pc_op.apply
        kw = dict(maxiter=maxiter, rtol=rtol, atol=atol)
        if self.method == "cg":
            return krylov.cg(op.mv, b, x0, precond=M, batched=batched, **kw)
        if self.method == "minres":
            return krylov.minres(op.mv, b, x0, precond=M, batched=batched,
                                 **kw)
        if self.method == "bicgstab":
            return krylov.bicgstab(op.mv, b, x0, precond=M, batched=batched,
                                   **kw)
        # right-preconditioned GMRES: solve (A M) y = b, x = M y, so the
        # Givens estimate tracks the true residual
        if M is None:
            return krylov.gmres(op.mv, b, x0, restart=restart, **kw)
        res = krylov.gmres(lambda v: op.mv(M(v)), b, restart=restart, **kw)
        return dataclasses.replace(res, x=M(res.x))

    def solve(self, b, x0=None) -> Tuple[np.ndarray, dict]:
        """Solve for one right-hand side ``(n,)`` or a panel ``(n, k)``
        (the KSPMatSolve analog: the ``k`` systems iterate together, each
        frozen once converged).  Same return contract as ``solve``."""
        A, dt, dev = self._A, self._dt, self._device
        n = A.shape[0]
        b_host = np.asarray(b, np.float64)
        multi = b_host.ndim == 2
        if not multi:
            b_host = b_host.reshape(-1)
        if b_host.shape[0] != n:
            raise ValueError(
                f"b has length {b_host.shape[0]}, matrix is {n}")

        def on_device(a):
            # the device works on systems as rows: (k, n)
            a = a.T if multi else a
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dt)

        bt = on_device(b_host)
        xt0 = None
        if x0 is not None:
            xt0 = on_device(np.asarray(x0, np.float64).reshape(b_host.shape))

        if self.method in ("cg", "minres", "bicgstab", "gmres"):
            res = self._run(bt, xt0, multi)
        else:  # ca_gmres (bounds estimated once, at prepare time)
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.castep import (  # noqa: E501
                ca_gmres,
            )

            if multi:
                raise ValueError(
                    "ca_gmres supports a single RHS (its Newton-basis "
                    "panel cycle does not vmap); use gmres/cg/minres "
                    "for b (n, k)")
            rtol, atol, maxiter, _, s = self._cfg
            lmin, lmax = self._bounds
            res = ca_gmres(self._op.mv, bt, xt0, s=s, maxiter=maxiter,
                           rtol=rtol, atol=atol, lmin=lmin, lmax=lmax)

        def host(t, dtype=np.float64):
            return np.asarray(torch.as_tensor(t).cpu().numpy(), dtype)

        x_host = host(res.x)
        if multi:
            x_host = np.ascontiguousarray(x_host.T)
        r = b_host - A @ x_host
        bn = np.linalg.norm(b_host, axis=0)
        rn = np.linalg.norm(r, axis=0)
        rel = np.divide(rn, bn, out=np.zeros_like(rn), where=bn > 0)
        converged = host(res.converged, bool)
        info = dict(
            converged=bool(converged.all()),
            iters=(host(res.iters, np.int32) if multi else int(res.iters)),
            rel_residual=(rel if multi else float(rel)),
            resnorm=(host(res.resnorm) if multi else float(res.resnorm)),
            resnorm0=(host(res.resnorm0) if multi else float(res.resnorm0)),
            operator=type(self._op).__name__,
            method=self.method,
            pc=self.pc,
        )
        if multi:
            info["converged_per_rhs"] = converged
        return x_host, info


def prepare(A, *, method: str = "gmres", rtol: float = 1e-8,
            atol: float = 0.0, maxiter: int = 10000, restart: int = 30,
            pc: str = "none", pc_block_size: int = 64,
            dtype: Optional[torch.dtype] = None, s: int = 8,
            assume_a: Optional[str] = None, device=None) -> PreparedSolver:
    """Route ``A``, build the preconditioner on ``device``, and return a
    ``PreparedSolver`` whose ``.solve(b)`` reuses all of it: for one
    matrix solved against many right-hand sides.  See ``solve`` for the
    options."""
    if method not in ("auto", "gmres", "cg", "minres", "bicgstab",
                      "ca_gmres"):
        raise ValueError(
            f"method must be auto | gmres | cg | minres | bicgstab | "
            f"ca_gmres, got {method!r}")
    if pc not in ("auto", "none", "jacobi", "bjacobi", "amg"):
        raise ValueError(
            f"pc must be auto | none | jacobi | bjacobi | amg, got {pc!r}")
    if assume_a not in (None, "gen", "sym", "pos"):
        raise ValueError(
            f"assume_a must be gen | sym | pos, got {assume_a!r}")
    A = sp.csr_matrix(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"solve needs a square matrix, got {A.shape}")
    device = resolve(device)

    if method == "auto":
        method = _auto_method(A, assume_a)

    dt = torch.float32 if dtype is None else dtype
    op = from_scipy(A, dtype=dt, device=device)
    if pc == "auto":
        pc = _auto_pc(A, op, method)
        if pc == "bjacobi":
            pc_block_size = op.bs

    pc_op = None
    if pc == "jacobi":
        d = np.asarray(A.diagonal(), np.float64)
        d[d == 0] = 1.0
        pc_op = torch.from_numpy(1.0 / d).to(device=device, dtype=dt)
    elif pc == "bjacobi":
        pc_op = block_jacobi_from_scipy(A, bs=pc_block_size, dtype=dt,
                                        device=device)
    elif pc == "amg":
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.amg import (
            amg_setup,
        )

        pc_op = amg_setup(A, dtype=dt, device=device)

    bounds = None
    if method == "ca_gmres":
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.eigest import (  # noqa: E501
            lanczos_bounds,
        )

        if pc_op is not None:
            raise ValueError(
                "ca_gmres does not compose with pc (its Newton shifts "
                "are derived for the unpreconditioned spectrum)")
        bounds = lanczos_bounds(op.mv, A.shape[0], dtype=dt, device=device)

    return PreparedSolver(A=A, op=op, pc_op=pc_op, method=method, pc=pc,
                          rtol=rtol, atol=atol, maxiter=maxiter,
                          restart=restart, s=s, dt=dt, device=device,
                          bounds=bounds)


def solve(A, b, *, method: str = "gmres", rtol: float = 1e-8,
          atol: float = 0.0, maxiter: int = 10000, restart: int = 30,
          pc: str = "none", pc_block_size: int = 64, x0=None,
          dtype: Optional[torch.dtype] = None, s: int = 8,
          assume_a: Optional[str] = None,
          device=None) -> Tuple[np.ndarray, dict]:
    """Solve ``A x = b`` for a square ``scipy.sparse`` (or dense numpy)
    matrix on the routed operator: the one-shot form of
    ``prepare(A, ...).solve(b)``.

    ``method``: "gmres" | "cg" (SPD) | "minres" (symmetric, possibly
    indefinite) | "bicgstab" | "ca_gmres" (SPD, ``s``-step Newton basis
    on a Lanczos-estimated interval) | "auto" (host symmetry check:
    minres for symmetric, gmres otherwise; ``assume_a``, the
    ``scipy.linalg.solve`` convention, overrides the check: "pos" -> cg,
    "sym" -> minres, "gen" -> gmres).

    ``pc``: "none" | "jacobi" | "bjacobi" | "amg" | "auto".  "bjacobi"
    inverts ``pc_block_size``-sized diagonal blocks; "amg" builds a
    smoothed-aggregation hierarchy (``solvers/amg.py``); "auto" picks
    bjacobi on a BSR-routed operator at the routed block size, jacobi on
    a nonzero diagonal, none otherwise.  gmres and bicgstab compose on the
    right (the convergence test sees the true residual); cg and minres
    use the standard SPD-M composition with the test on ``||r||_2`` and
    ``||r||_M``.

    ``b`` may be a panel ``(n, k)`` of ``k`` independent right-hand
    sides, solved together; ``info`` then holds per-column numpy arrays
    plus the scalar ``converged`` (all columns) and
    ``converged_per_rhs``.

    ``dtype``: the device solve's type (default ``torch.float32``).
    ``device``: None for the current CUDA device (an error without one),
    or ``"cpu"``.

    Returns ``(x, info)``: ``x`` as float64 numpy, ``info`` with
    ``converged``, ``iters``, ``rel_residual`` (measured on the host in
    f64 against the input matrix), ``resnorm``, ``resnorm0``,
    ``operator`` (the routed representation), ``method`` and ``pc``."""
    prep = prepare(A, method=method, rtol=rtol, atol=atol, maxiter=maxiter,
                   restart=restart, pc=pc, pc_block_size=pc_block_size,
                   dtype=dtype, s=s, assume_a=assume_a, device=device)
    return prep.solve(b, x0=x0)


def lstsq(A, b, *, method: str = "lsqr", rtol: float = 1e-8,
          atol: float = 0.0, maxiter: int = 10000, x0=None,
          dtype: Optional[torch.dtype] = None,
          device=None) -> Tuple[np.ndarray, dict]:
    """``min_x ||A x - b||_2`` for a rectangular (or square inconsistent)
    ``scipy.sparse`` or numpy matrix on the routed operator.

    ``method``: "lsqr" (Golub-Kahan, the robust default) | "cgne" (CG on
    the normal equations: cheaper per iteration, squares the condition
    number) | "qr" (direct Householder QR of the densified operator, for
    ``m >= n`` and at most 64 Mi entries).

    The iterative methods stop on the Paige-Saunders rules: ``||r|| <=
    max(rtol ||b||, atol)`` (consistent systems) or ``||A^T r|| <= rtol
    ||A^T b||`` (the least-squares optimum).

    Returns ``(x, info)`` with ``info["rel_opt"] = ||A^T r|| / ||A^T b||``
    (host f64, against the input matrix) beside ``rel_residual``."""
    if method not in ("lsqr", "cgne", "qr"):
        raise ValueError(f"method must be lsqr | cgne | qr, got {method!r}")
    A = sp.csr_matrix(A)
    m, n = A.shape
    b_host = np.asarray(b, np.float64).reshape(-1)
    if b_host.shape[0] != m:
        raise ValueError(f"b has length {b_host.shape[0]}, matrix is "
                         f"{m}x{n}")
    device = resolve(device)

    dt = torch.float32 if dtype is None else dtype
    op = from_scipy(A, dtype=dt, device=device)
    bt = torch.from_numpy(b_host).to(device=device, dtype=dt)
    xt0 = None if x0 is None else torch.from_numpy(
        np.asarray(x0, np.float64).reshape(-1)).to(device=device, dtype=dt)

    if method == "qr":
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
            lstsq_qr,
        )

        if m < n:
            raise ValueError(
                f"method='qr' needs m >= n (tall Householder QR), got "
                f"{m}x{n}; use 'lsqr' for underdetermined systems")
        if m * n > 64 * 1024 * 1024:
            raise ValueError(
                f"method='qr' densifies the operator ({m}x{n} = "
                f"{m * n} entries); use 'lsqr' at this size")
        x = lstsq_qr(op.to_dense(), bt)
        iters, converged = 0, True
        resnorm = resnorm0 = None
    else:
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lsqr import (
            cgne,
            lsqr,
        )

        kw = dict(maxiter=maxiter, rtol=rtol, atol=atol)
        if method == "lsqr":
            res = lsqr(op.mv, op.rmv, bt, xt0, n=n, **kw)
        else:
            res = cgne(op.mv, op.rmv, bt, xt0, **kw)
        x = res.x
        iters, converged = int(res.iters), bool(res.converged)
        resnorm, resnorm0 = float(res.resnorm), float(res.resnorm0)

    x_host = np.asarray(x.cpu().numpy(), np.float64)
    r = b_host - A @ x_host
    atr = A.T @ r
    atb = A.T @ b_host
    bn = np.linalg.norm(b_host)
    atbn = np.linalg.norm(atb)
    info = dict(
        converged=converged,
        iters=iters,
        rel_residual=float(np.linalg.norm(r) / bn) if bn > 0 else 0.0,
        rel_opt=float(np.linalg.norm(atr) / atbn) if atbn > 0 else 0.0,
        operator=type(op).__name__,
        method=method,
    )
    if resnorm is not None:
        info["resnorm"], info["resnorm0"] = resnorm, resnorm0
        # lsqr's estimates live on the ||r|| scale; cgne runs CG on the
        # normal equations, so its resnorm is ||A^T r||.  rel_residual and
        # rel_opt above are host f64 against the input and comparable.
        info["resnorm_scale"] = (
            "residual" if method == "lsqr" else "normal_equation")
    return x_host, info
