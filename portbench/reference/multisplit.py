"""Asynchronous multisplitting (the thesis's AM) on the 2D Poisson grid,
written out plainly: one block at a time, the stencil of
``reference/stencil.py``, and a textbook restarted GMRES.

Written from the port's documents (``models/multisplitting.py``'s module
and ``multisplit_solve`` docstrings and comments, ``InnerConfig``'s
docstring, ``solvers/krylov.gmres``'s docstring), not from its code:

* the grid's rows are split into ``nblocks`` strips of equal height;
  block ``i`` owns strip ``i``.  Its diagonal block ``A_ii`` is the
  stencil on the strip alone (zero outside it); its coupling rows
  ``sum_{j != i} A_ij x_j`` are the stencil applied to the whole grid with
  strip ``i`` zeroed, read on strip ``i``;
* the test's reference norm is ``||b - A x0||`` (x0 = 0); the global
  threshold is ``rtol`` times it, the per-block one ``rtol / sqrt(nblocks)``
  times it;
* a sweep: every block solves ``A_ii x_i = b_i - coupling_i(visible x)``
  from its current ``x_i`` by GMRES; after sweep ``k`` (counted from 1)
  block ``i`` publishes its new iterate when ``k % staleness == 0``, and
  the coupling right-hand sides are formed again from what is visible;
* the convergence test after each sweep (no minimization: one sweep a
  cycle): block ``i`` is under when ``||rhs_i - A_ii x_i||`` is at most the
  per-block threshold.  The pseudo-period gate: an under block's count
  grows only in a sweep in which every block published, and otherwise
  keeps its value; a block over the threshold is set back to 0.  The
  sweeps stop when every count has reached ``min_convergence_count``, or
  at ``maxiter`` sweeps;
* the certification tail, for a run that stopped on its counts: lockstep
  sweeps on the true coupling (every block sees every peer's newest
  iterate) until every block's true residual ``||b_i - (A x)_i||`` is at
  most the per-block threshold, at most ``max_tail`` of them.  The answer
  is certified when the run stopped on its counts and the tail ended
  under the threshold.

GMRES (``gmres`` below): Arnoldi by modified Gram-Schmidt, the Hessenberg
least squares by ``torch.linalg.lstsq`` after every step, and the
residual estimate read from it; a system stops when the estimate is at
most ``rtol`` times its initial residual, at a happy breakdown (the new
direction's norm at most ``eps`` times the norm of the Hessenberg column),
or after ``maxiter`` steps in all, with a restart every ``restart``
steps.

Departures from the port, none of which changes what is computed in exact
arithmetic: the port orthogonalises by two passes of classical
Gram-Schmidt and solves the least squares by Givens rotations; it runs
the blocks as one batch and masks finished ones; it reads the device
only at the tests.  Here each Arnoldi step reads the estimate on the
host.  GMRES's divergence stop (``divtol``) is left out: the inner solves
of this schedule never come near it.

It imports nothing of the port and no JAX.  It computes in ``dtype``
(f64 by default) on the device of ``b``; the small Hessenberg problems
are solved on the host in that dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from portbench.reference.stencil import poisson_apply


@dataclasses.dataclass
class AMResult:
    x: torch.Tensor          # the answer on the grid, in the run's dtype
    sweeps: int              # sweeps in all, the tail's included
    tail_sweeps: int         # sweeps of the certification tail
    certified: bool
    inner_iters: int         # GMRES steps of the gated sweeps, all blocks


def gate(count: int, under: bool, all_published: bool) -> int:
    """A block's count after a sweep: the pseudo-period gate."""
    if not under:
        return 0
    return count + 1 if all_published else count


def gmres(apply: Callable, rhs: torch.Tensor, x0: torch.Tensor, *,
          restart: int = 30, maxiter: int = 20, rtol: float = 1e-3):
    """``(x, steps)``: restarted GMRES on ``apply(x) = rhs`` from ``x0``,
    vectors of one shape, stopping as the module's docstring says."""
    dtype = rhs.dtype
    eps = torch.finfo(dtype).eps
    x = x0.clone()
    r = rhs - apply(x)
    beta0 = torch.linalg.vector_norm(r).item()
    tol = rtol * beta0
    steps = 0
    if beta0 <= tol:
        return x, steps
    while steps < maxiter:
        beta = torch.linalg.vector_norm(r).item()
        m = min(restart, maxiter - steps)
        basis = [r / beta if beta > 0 else r]
        hess = torch.zeros((m + 1, m), dtype=dtype)
        done, k = False, 0
        for j in range(m):
            w = apply(basis[j])
            col = []
            for v in basis:                      # modified Gram-Schmidt
                h = torch.dot(v.reshape(-1), w.reshape(-1))
                w = w - h * v
                col.append(h)
            hnext = torch.linalg.vector_norm(w)
            col = torch.stack(col + [hnext]).cpu()
            hess[:j + 2, j] = col
            basis.append(w / hnext if hnext > 0 else w)
            k, steps = j + 1, steps + 1
            e1 = torch.zeros(k + 1, dtype=dtype)
            e1[0] = beta
            y = torch.linalg.lstsq(hess[:k + 1, :k], e1[:, None]).solution
            estimate = torch.linalg.vector_norm(
                e1 - (hess[:k + 1, :k] @ y)[:, 0]).item()
            happy = col[-1].item() <= eps * torch.linalg.vector_norm(col).item()
            if estimate <= tol or happy:
                done = True
                break
        y = y[:, 0].to(x.device)
        for i in range(k):
            x = x + y[i] * basis[i]
        if done:
            break
        r = rhs - apply(x)
    return x, steps


def am(b: torch.Tensor, nblocks: int = 2, *, diag: float = 4.0,
       off: float = -1.0, staleness: int = 2, rtol: float = 1e-3,
       maxiter: int = 10000, min_convergence_count: int = 4,
       inner: Optional[dict] = None, max_tail: int = 64,
       dtype: torch.dtype = torch.float64) -> AMResult:
    """AM on ``A x = b`` with ``b`` an ``(n1, n2)`` grid, ``n1`` a multiple
    of ``nblocks``; ``inner`` holds GMRES's ``restart``, ``maxiter`` and
    ``rtol`` (default 30, 20, 1e-3: the reference's inner KSP)."""
    inner = dict({"restart": 30, "maxiter": 20, "rtol": 1e-3}, **(inner or {}))
    if inner.pop("method", "gmres") != "gmres":
        raise ValueError("the reference's inner solve is GMRES")
    b = b.to(dtype)
    n1 = b.shape[0]
    if b.dim() != 2 or n1 % nblocks:
        raise ValueError(f"a 2D grid of rows that split into {nblocks} strips "
                         f"is needed, got {tuple(b.shape)}")
    h = n1 // nblocks
    strips = [slice(i * h, (i + 1) * h) for i in range(nblocks)]

    def a_ii(u):
        return poisson_apply(u, diag, off)

    def coupling(i, grid):
        peers = grid.clone()
        peers[strips[i]] = 0
        return poisson_apply(peers, diag, off)[strips[i]]

    def norm(u):
        return torch.linalg.vector_norm(u).item()

    x = torch.zeros_like(b)
    rnorm0 = norm(b - poisson_apply(x, diag, off))
    tol_local = rtol / math.sqrt(nblocks) * rnorm0
    visible = x.clone()
    rhs = [b[s] - coupling(i, visible) for i, s in enumerate(strips)]
    counts = [0] * nblocks
    sweeps = iters = 0
    stopped = rnorm0 <= rtol * rnorm0
    while not stopped and sweeps < maxiter:
        for i, s in enumerate(strips):
            x[s], k = gmres(a_ii, rhs[i], x[s], **inner)
            iters += k
        sweeps += 1
        published = sweeps % staleness == 0
        if published:
            visible = x.clone()
        rhs = [b[s] - coupling(i, visible) for i, s in enumerate(strips)]
        counts = [gate(c, norm(rhs[i] - a_ii(x[s])) <= tol_local, published)
                  for i, (c, s) in enumerate(zip(counts, strips))]
        stopped = all(c >= min_convergence_count for c in counts)

    tail = 0
    if stopped:
        def under():
            return all(norm(b[s] - coupling(i, x) - a_ii(x[s])) <= tol_local
                       for i, s in enumerate(strips))

        ok = under()
        while not ok and tail < max_tail:
            rhs = [b[s] - coupling(i, x) for i, s in enumerate(strips)]
            x_new = x.clone()
            for i, s in enumerate(strips):
                x_new[s], _ = gmres(a_ii, rhs[i], x[s], **inner)
            x = x_new
            tail += 1
            ok = under()
        stopped = ok
    return AMResult(x=x, sweeps=sweeps + tail, tail_sweeps=tail,
                    certified=bool(stopped), inner_iters=iters)
