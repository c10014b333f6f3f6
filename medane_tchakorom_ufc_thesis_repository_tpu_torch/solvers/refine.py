"""Mixed-precision iterative refinement: the 2D and 3D Poisson north-star
solves (port of the JAX package's ``solvers/refine.py``).

Three loops share one idea, an f32 device solve of the correction
problem around a residual of f64 accuracy: ``iterative_refinement`` (f64
residual on the host, in numpy), ``device_iterative_refinement`` (f64
residual on the device) and the double-float pair
``df_iterative_refinement`` / ``df_northstar_fused`` (no f64 on the
device at all).  In the north-star each pass solves the correction problem in f32 with W-cycle-
preconditioned CG, adds the correction to a double-float (two-f32) x,
and recomputes the true residual in double-float (``solvers/df64.py``),
until ``||b - A x|| <= rtol ||b||``.  JAX runs the pass loop as one
``lax.while_loop``; here it is a Python loop over device tensors that
reads one boolean per pass and per CG iteration.  ``df_northstar_fused``
runs through ``_df_fused_program``, the twin of JAX's jitted program:
static buffers, and on the card the work between two reads as one
replay of a CUDA graph.  ``RefineResult`` reports the CG iterations of
each pass and the number of those host reads.

JAX's ``_df_refine_helpers`` and ``_device_refine_helpers`` are caches of
jitted helpers: eager PyTorch compiles nothing, so they have no twin.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import types
from typing import Callable, List

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
    PCGState,
    _entry_norms,
    _vdot,
    pcg_iteration,
    pcg_live,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
    mg_preconditioner,
)

_DIVTOL = 1e5     # cg's default divergence bound, which the north-star keeps


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


def iterative_refinement(
    solve_f32: Callable,
    mv_f64: Callable,
    b,
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
    device=None,
) -> RefineResult:
    """Drive ``solve_f32`` to f64 accuracy by refinement with the residual
    on the host.  ``solve_f32(r32) -> d32`` is any device solve taking and
    returning flat f32 tensors on ``device`` (None: the current CUDA
    device); ``mv_f64`` is the exact operator in f64 on numpy arrays
    (``stencil2d_mv_np``, ``stencil3d_mv_np``); ``b`` the f64 right-hand
    side."""
    device = resolve(device)
    b = np.asarray(b, np.float64)
    rnorm0 = float(np.linalg.norm(b))
    if rnorm0 == 0.0:
        return RefineResult(np.zeros_like(b), 0, [], 0.0, 0.0, True)
    x = np.zeros_like(b)
    history: List[float] = []
    syncs = 0
    for p in range(max_passes + 1):
        r = b - mv_f64(x)
        rnorm = float(np.linalg.norm(r))
        history.append(rnorm / rnorm0)
        if history[-1] <= rtol or p == max_passes:
            break
        # scale the correction problem to O(1): the whole f32 range
        # serves the inner solve
        d32 = solve_f32(torch.from_numpy((r / rnorm).astype(np.float32))
                        .to(device))
        x = x + rnorm * d32.detach().cpu().numpy().astype(np.float64)
        syncs += 1
    return RefineResult(x, len(history) - 1, history, rnorm, rnorm0,
                        history[-1] <= rtol, syncs=syncs)


def device_iterative_refinement(
    matvec: Callable,
    b64,
    solve_f32: Callable,
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
    device=None,
) -> RefineResult:
    """Refinement with the f64 residual computed on the device: only
    scalars cross to the host (one norm per pass).  ``matvec`` must
    evaluate in the dtype of its argument, f32 and f64 alike (true of the
    matrix-free stencils); ``b64`` is the f64 right-hand side, a numpy
    array or a tensor, of any shape ``matvec`` accepts.  ``RefineResult.x``
    is an f64 numpy array."""
    if isinstance(b64, torch.Tensor):
        b64 = b64.to(torch.float64)
    else:
        b64 = torch.from_numpy(np.array(b64, dtype=np.float64)).to(
            resolve(device))
    rnorm0 = float(torch.sqrt(torch.sum(b64 * b64)))
    syncs = 1
    if rnorm0 == 0.0:
        return RefineResult(np.zeros(tuple(b64.shape)), 0, [], 0.0, 0.0, True,
                            syncs=syncs)
    x64 = torch.zeros_like(b64)
    history: List[float] = []
    r64, rnorm = b64, rnorm0   # x = 0: r = b exactly, no f64 matvec
    for p in range(max_passes + 1):
        if p > 0:
            r64 = b64 - matvec(x64)
            rnorm = float(torch.sqrt(torch.sum(r64 * r64)))
            syncs += 1
        history.append(rnorm / rnorm0)
        if history[-1] <= rtol or p == max_passes:
            break
        d32 = solve_f32((r64 / rnorm).to(torch.float32))
        x64 = x64 + rnorm * d32.to(torch.float64)
    return RefineResult(x64.cpu().numpy(), len(history) - 1, history, rnorm,
                        rnorm0, history[-1] <= rtol, syncs=syncs)


@functools.lru_cache(maxsize=4)
def _df_fused_program(op, rtol: float, max_passes: int, inner_rtol: float,
                      pcg_maxiter: int, nu: int, min_size: int,
                      coarse_iters: int, cycle: str) -> "_FusedProgram":
    """The program of the df-refined MG-PCG north-star for one operator and
    one set of static parameters (the JAX package's cache key), cached:
    the twin of JAX's jitted ``_df_fused_program``.  Few are kept, since
    each holds its static buffers and, on the card, a graph memory pool;
    ``_df_fused_program.cache_clear()`` frees them."""
    return _FusedProgram(op, rtol, max_passes, inner_rtol, pcg_maxiter, nu,
                         min_size, coarse_iters, cycle)


class _FusedProgram:
    """``run(bhi, blo)``: the north-star solve with its state in static
    buffers, each step one function.

    JAX runs the pass loop as one ``lax.while_loop`` with CG inside and
    reads the device once.  Here the host keeps the loop and reads its
    tests where the eager solve reads them (one bool a pass and one a CG
    iteration); the work between two reads runs as one replay of a CUDA
    graph: one graph of a PCG iteration (W-cycle, matvec, dots, updates,
    the next loop test) and one of the pass tail (df update, df residual,
    scaled norm, pass test, the next pass's CG start).  Each graph is
    captured after its first call, which runs eagerly, on a side stream,
    as its warm-up and does that call's work; a failed capture raises.
    On a CPU tensor the same step functions run eagerly.

    Updated in place: the CG state (x, r, p written with ``out=``, the
    scalars copied), and xhi, xlo (the df update's result copied in)."""

    def __init__(self, op, rtol, max_passes, inner_rtol, pcg_maxiter, nu,
                 min_size, coarse_iters, cycle):
        self.op, self.rtol, self.max_passes = op, rtol, max_passes
        self.inner_rtol, self.pcg_maxiter = inner_rtol, pcg_maxiter
        self.residual = df64.df_residual_for(op)
        # return_rdot: PCG's r·z comes out of the cycle's last sweep
        self.Md = mg_preconditioner(op, nu=nu, min_size=min_size,
                                    coarse_iters=coarse_iters, cycle=cycle,
                                    return_rdot=True)
        self.st = None
        self.graphs = {}
        self.pool = None
        self.capture_s = 0.0     # seconds spent capturing, warm-ups apart

    def _state(self, bhi: torch.Tensor):
        """The static buffers for a right-hand side like ``bhi``, made at
        the first call (and anew on another device or shape)."""
        st = self.st
        if st is not None and st.bhi.shape == bhi.shape \
                and st.bhi.device == bhi.device:
            return st
        grid = [torch.zeros_like(bhi) for _ in range(7)]
        scalar = [torch.zeros((), dtype=bhi.dtype, device=bhi.device)
                  for _ in range(7)]
        flag = [torch.zeros((), dtype=torch.bool, device=bhi.device)
                for _ in range(3)]
        self.st = st = types.SimpleNamespace(
            bhi=grid[0], blo=grid[1], xhi=grid[2], xlo=grid[3],
            pcg=PCGState(x=grid[4], r=grid[5], p=grid[6], rs=scalar[0],
                         rz=scalar[1]),
            rn0=scalar[2], tol=scalar[3], rnorm=scalar[4], rnorm0=scalar[5],
            tol_pass=scalar[6], live=flag[0], first=flag[1], go=flag[2])
        self.graphs = {}
        return st

    def _cg_start(self, rhi: torch.Tensor) -> None:
        """``cg``'s entry on ``rhi / rnorm`` from the zero guess."""
        st = self.st
        torch.div(rhi.reshape(st.pcg.r.shape), st.rnorm, out=st.pcg.r)
        st.pcg.x.zero_()
        st.pcg.p.zero_()
        rs, rn0, tol = _entry_norms(st.pcg.r, None, self.inner_rtol, 0.0,
                                    _vdot)
        st.pcg.rs.copy_(rs)
        st.rn0.copy_(rn0)
        st.tol.copy_(tol)
        st.pcg.rz.fill_(1.0)
        st.first.fill_(True)
        st.live.copy_(pcg_live(st.pcg.rs, st.tol, st.rn0, _DIVTOL))

    def _iteration(self) -> None:
        """One PCG iteration and the next loop test."""
        st = self.st
        pcg_iteration(st.pcg, st.first, matvec=self.op.mv,
                      precond_dot=self.Md,
                      matvec_dot=getattr(self.op, "mv_dot", None),
                      in_place=True)
        st.first.fill_(False)
        st.live.copy_(pcg_live(st.pcg.rs, st.tol, st.rn0, _DIVTOL))

    def _tail(self) -> None:
        """The pass tail: x += rnorm * d in double-float, the df residual,
        its norm, the pass test, and the next pass's CG start."""
        st = self.st
        d = st.pcg.x
        upd = df64.df_mul_f32((d, torch.zeros_like(d)), st.rnorm)
        xhi, xlo = df64.df_add((st.xhi, st.xlo), upd)
        st.xhi.copy_(xhi)
        st.xlo.copy_(xlo)
        rhi, _ = self.residual((st.bhi, st.blo), (st.xhi, st.xlo))
        st.rnorm.copy_(df64.scaled_norm(rhi))
        st.go.copy_(st.rnorm > st.tol_pass)
        self._cg_start(rhi)

    def _run(self, name: str, step) -> None:
        """``step()``: eagerly on the CPU; on the card a replay of its
        graph, captured after the first call."""
        if self.st.bhi.device.type != "cuda":
            step()
            return
        g = self.graphs.get(name)
        if g is not None:
            g.replay()
            return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()                      # warm-up: this call's own work
        torch.cuda.current_stream().wait_stream(side)
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph, pool = torch.cuda.CUDAGraph(), self.pool
        # the context refers to no ``self``: no cycle keeps a cleared
        # program's buffers alive until the garbage collector runs
        g = build.CountedGraph(graph,
                               lambda: torch.cuda.graph(graph, pool=pool))
        g.capture(step)
        self.graphs[name] = g
        self.capture_s += time.perf_counter() - t0

    def __call__(self, bhi: torch.Tensor, blo: torch.Tensor):
        """Solve for ``b = bhi + blo``; returns ``(xhi, xlo, passes,
        pcg_iters, rnorm, rnorm0, syncs)``."""
        st = self._state(bhi)
        st.bhi.copy_(bhi)
        st.blo.copy_(blo)
        st.xhi.zero_()
        st.xlo.zero_()
        rnorm0 = df64.scaled_norm(st.bhi)
        st.rnorm0.copy_(rnorm0)
        st.rnorm.copy_(rnorm0)
        st.tol_pass.copy_(self.rtol * rnorm0)
        st.go.copy_(st.rnorm > st.tol_pass)
        self._cg_start(st.bhi)
        passes = syncs = 0
        pcg_iters: List[int] = []
        while passes < self.max_passes:
            syncs += 1
            if not bool(st.go):
                break
            trips = 0
            while trips < self.pcg_maxiter:
                syncs += 1
                if not bool(st.live):
                    break
                self._run("iteration", self._iteration)
                trips += 1
            pcg_iters.append(trips)
            self._run("tail", self._tail)
            passes += 1
        stats = torch.stack([st.rnorm, st.rnorm0]).cpu()   # one read for both
        syncs += 1
        return (st.xhi.clone(), st.xlo.clone(), passes, pcg_iters,
                float(stats[0]), float(stats[1]), syncs)


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
    relative TRUE residual, through the cached program
    ``_df_fused_program`` (CUDA graphs on the card).  ``b_df``: the
    (hi, lo) f32 pair of b; when None, ``b = A·1`` is built on ``device``
    (None: the current CUDA device).  ``RefineResult.x`` is the device
    (hi, lo) pair; ``rel_history`` stays empty, as in JAX."""
    run = _df_fused_program(op, float(rtol), int(max_passes),
                            float(inner_rtol), int(pcg_maxiter), int(nu),
                            int(min_size), int(coarse_iters), str(cycle))
    if b_df is None:
        bhi = op.mv(torch.ones(op.dims, dtype=torch.float32,
                               device=resolve(device)))
        b_df = (bhi, torch.zeros_like(bhi))
    xhi, xlo, passes, pcg_iters, rn, rn0, syncs = run(*b_df)
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


def stencil2d_mv_np(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """Exact f64 host matvec for the 2D 5-point operator (numpy)."""

    def mv(x):
        g = np.asarray(x, np.float64).reshape(m, n)
        y = diag * g
        y[1:, :] += off * g[:-1, :]
        y[:-1, :] += off * g[1:, :]
        y[:, 1:] += off * g[:, :-1]
        y[:, :-1] += off * g[:, 1:]
        return y.reshape(-1)

    return mv


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
