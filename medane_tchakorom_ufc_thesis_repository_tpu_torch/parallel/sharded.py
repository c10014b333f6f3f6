"""Sharded multisplitting: the multi-device execution path (port of the
JAX package's ``parallel/sharded.py``).

The mathematics of ``models.multisplitting`` laid out over a mesh
``('block', 'intra')`` (``parallel/mesh.py``):

* each shard owns a contiguous strip of grid rows (2D) or x-planes (3D),
  kept in the canonical local layout ``(rows, fdim)``, ``fdim`` the
  product of the unsplit grid dims (n in 2D, ny*nz in 3D), so boundary
  rows are ``g[..., 0, :]`` / ``g[..., -1, :]`` at any grid rank;
* the inner GMRES runs per block as a collective over ``'intra'`` (the
  reference's per-block KSPSolve on its sub-communicator), with fixed
  cycle counts so that blocks stay in lockstep;
* the diagonal-block apply exchanges one boundary row between intra
  neighbours by ``ppermute`` (PETSc's VecScatter halos), the coupling
  ships the cut rows across ``'block'`` (the reference's
  ``comm_sync_send_and_receive``, ``src/utils/comm.c:126-141``);
* norms are two-level psums, 'intra' then 'block'
  (``computeFinalResidualNorm``, ``utils.c:575-595``).

Each shard's interior apply is a kernel launch over the whole shard
stack: kernel E in 2D (``ops.stencil2d``; an s-step basis panel ``R = A
S`` is its ``[spmm]`` launch), kernel A kind ``mv`` in 3D (``ops.stencil3d``
on the ``(T, nx, ny, nz)`` stack of tiles), both with zero external halos; the halo
rows are added after the apply, as JAX's ``.at[..., 0, :].add(off *
top)``, and the halos are exchanged before it (JAX's overlap order).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
    MultisplitResult,
    OuterConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil2d import (
    stencil2d_apply,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d import (
    stencil3d_apply,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov

STRIP = ("block", "intra")


def stack_apply(g: torch.Tensor, nd: int, diag: float, off: float,
                panel: bool = False) -> torch.Tensor:
    """The stencil apply with zero external halos on every grid of ``g``
    (its last ``nd`` axes a grid, the leading ones a stack of shards'
    tiles): one launch over the whole stack, of kernel E in 2D (``panel``
    names an s-step basis launch) or of kernel A kind ``mv`` in 3D."""
    if nd == 2:
        y = stencil2d_apply(g.reshape(-1, *g.shape[-2:]).contiguous(),
                            diag=diag, off=off, panel=panel)
        return y.reshape(g.shape)
    y = stencil3d_apply(g.reshape(-1, *g.shape[-3:]).contiguous(), kind="mv",
                        diag=diag, off=off)
    return y.reshape(g.shape)


# ---------------------------------------------------------------------------
# Sharded stencil configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPoisson2D:
    """2D 5-point Poisson on ``m x n``, grid rows sharded over the mesh."""

    m: int
    n: int
    diag: float = 4.0
    off: float = -1.0

    @property
    def split_extent(self) -> int:
        return self.m

    @property
    def fdim(self) -> int:
        return self.n

    @property
    def global_shape(self):
        return (self.m, self.n)

    @property
    def nnz(self) -> int:
        return 5 * self.m * self.n - 2 * self.m - 2 * self.n

    def interior_mv(self, g: torch.Tensor, panel: bool = False) -> torch.Tensor:
        """Each local strip's apply with zero external halos; ``g`` is
        ``(..., rows, n)``, every leading axis a batch of strips."""
        return stack_apply(g, 2, self.diag, self.off, panel)


@dataclasses.dataclass(frozen=True)
class ShardedPoisson3D:
    """3D 7-point Poisson on ``nx x ny x nz``, x-planes sharded; local
    layout ``(planes, ny*nz)``."""

    nx: int
    ny: int
    nz: int
    diag: float = 6.0
    off: float = -1.0

    @property
    def split_extent(self) -> int:
        return self.nx

    @property
    def fdim(self) -> int:
        return self.ny * self.nz

    @property
    def global_shape(self):
        return (self.nx, self.ny, self.nz)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        return 7 * nx * ny * nz - 2 * (nx * ny + ny * nz + nx * nz)

    def interior_mv(self, g: torch.Tensor, panel: bool = False) -> torch.Tensor:
        """Each local slab's apply with zero external halos; ``g`` is
        ``(..., planes, ny*nz)``."""
        grids = g.reshape(g.shape[:-1] + (self.ny, self.nz))
        return stack_apply(grids, 3, self.diag, self.off).reshape(g.shape)


# ---------------------------------------------------------------------------
# Halos and applies
# ---------------------------------------------------------------------------

def _check_spmd_configs(inner, outer) -> None:
    """Fail loudly on options the SPMD backends do not implement."""
    if inner.method not in ("gmres", "chebyshev", "ca_gmres"):
        raise ValueError(
            f"SPMD backends support inner methods 'gmres', 'chebyshev', "
            f"and 'ca_gmres', not {inner.method!r} (use the stacked "
            f"backend for 'cg')")
    if inner.pc not in ("none", "jacobi"):
        raise ValueError(
            f"SPMD backends implement inner pc 'none' and 'jacobi', "
            f"not {inner.pc!r}")
    if outer.method not in ("qr", "normal", "lsqr"):
        raise ValueError(
            f"SPMD backends implement outer methods 'qr' (distributed "
            f"TSQR), 'normal' (psum-reduced Gram), and 'lsqr' (sharded "
            f"Paige-Saunders), not {outer.method!r} — use the stacked "
            f"backend for cgne")


def _pairs(n: int):
    """``(up, down)`` neighbour pairs along an axis of extent ``n``."""
    return ([(i, i + 1) for i in range(n - 1)],
            [(i, i - 1) for i in range(1, n)])


def strip_halos(mesh, lead: str = "intra"):
    """``(intra(g), cross(g))`` for a mesh split along the grid's leading
    axis over ``('block', lead)``: the boundary rows from the neighbours
    in the same block, and from the neighbouring blocks (wrap within
    ``lead``, then shift across 'block'; zeros at the global Dirichlet
    boundary).  A mesh without a 'block' axis has no ``cross``
    (None)."""
    ni = mesh.shape[lead]
    up, down = _pairs(ni)

    def intra(g):
        top = mesh.ppermute(g[..., -1, :], lead, up)
        bot = mesh.ppermute(g[..., 0, :], lead, down)
        return top, bot

    if "block" not in mesh.shape:
        return intra, None
    bup, bdown = _pairs(mesh.shape["block"])

    def cross(g):
        top = mesh.ppermute(mesh.ppermute(g[..., -1, :], lead,
                                          [(ni - 1, 0)]), "block", bup)
        bot = mesh.ppermute(mesh.ppermute(g[..., 0, :], lead,
                                          [(0, ni - 1)]), "block", bdown)
        return top, bot

    return intra, cross


def _add_rows(y, off, top, bot):
    y[..., 0, :] += off * top
    y[..., -1, :] += off * bot
    return y


def make_full_mv(mesh, opcfg):
    """The whole-mesh stencil apply on the canonical local layout, shared
    by the sharded GMRES/CA-GMRES baselines: every halo exchanged first,
    the interior computed, then the halos consumed."""
    intra, cross = strip_halos(mesh)
    off = opcfg.off

    def full_mv(g):
        top_i, bot_i = intra(g)
        top_b, bot_b = cross(g)
        y = opcfg.interior_mv(g)
        return _add_rows(y, off, top_i + top_b, bot_i + bot_b)

    return full_mv


def _check_mesh(mesh, opcfg):
    if tuple(mesh.axis_names) != STRIP:
        raise ValueError(f"expected a ('block', 'intra') mesh, got "
                         f"{mesh.axis_names}")
    ndev = mesh.size
    if opcfg.split_extent % ndev:
        raise ValueError(f"grid extent {opcfg.split_extent} not divisible "
                         f"by {ndev} devices")
    return opcfg.split_extent // ndev


def _shard_rhs(mesh, opcfg, b):
    gshape = tuple(opcfg.global_shape)
    if tuple(b.shape) != gshape:
        raise ValueError(f"b must have grid shape {gshape}, got "
                         f"{tuple(b.shape)}")
    return mesh.shard(b.reshape(opcfg.split_extent, opcfg.fdim), (STRIP,))


def _unshard(mesh, opcfg, xs):
    flat = mesh.unshard(xs, (STRIP,), (opcfg.split_extent, opcfg.fdim))
    return flat.reshape(opcfg.global_shape)


def _first_result(mesh, opcfg, res, lshape):
    """A whole-mesh ``KrylovResult`` with the global ``x`` and shard 0's
    replicated scalars."""
    xs = res.x.reshape(mesh.local_shape + lshape)
    return krylov.KrylovResult(
        x=_unshard(mesh, opcfg, xs), iters=res.iters[0],
        resnorm=res.resnorm[0], resnorm0=res.resnorm0[0],
        converged=res.converged[0], syncs=res.syncs)


# ---------------------------------------------------------------------------
# Whole-mesh Krylov baselines
# ---------------------------------------------------------------------------

def sharded_gmres_solve(mesh, opcfg, b: torch.Tensor, *, restart: int = 30,
                        maxiter: int = 10000, rtol: float = 1e-5,
                        atol: float = 0.0, orthog: str = "cgs2"):
    """Full-system restarted GMRES over the whole mesh (the reference's
    ``gmres_solution`` baseline, ``gmres_solution.c:58-91``): the complete
    stencil, reductions over both mesh axes.  ``x`` comes back in grid
    shape."""
    rows = _check_mesh(mesh, opcfg)
    lshape = (rows, opcfg.fdim)
    full_mv = make_full_mv(mesh, opcfg)
    bs = _shard_rhs(mesh, opcfg, b)
    nsh = mesh.nlocal
    res = krylov.gmres(
        lambda v: full_mv(v.reshape(mesh.local_shape + lshape)).reshape(
            nsh, -1),
        bs.reshape(nsh, -1), restart=restart, maxiter=maxiter, rtol=rtol,
        atol=atol, orthog=orthog, axis_name=STRIP, mesh=mesh)
    return _first_result(mesh, opcfg, res, lshape)


def _analytic_bounds(opcfg, rows_factor: int = 1):
    """Dirichlet spectral interval of the whole domain's operator, or of
    one of ``rows_factor`` equal strips."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
        poisson_strip_eig_bounds_2d,
        poisson_strip_eig_bounds_3d,
    )

    if isinstance(opcfg, ShardedPoisson2D):
        return poisson_strip_eig_bounds_2d(opcfg.m // rows_factor, opcfg.n,
                                           opcfg.diag, opcfg.off)
    if isinstance(opcfg, ShardedPoisson3D):
        return poisson_strip_eig_bounds_3d(opcfg.nx // rows_factor, opcfg.ny,
                                           opcfg.nz, opcfg.diag, opcfg.off)
    return None


def sharded_ca_gmres_solve(mesh, opcfg, b: torch.Tensor, *, s: int = 12,
                           maxiter: int = 10000, rtol: float = 1e-5,
                           atol: float = 0.0, reductions: str = "single",
                           lmin: Optional[float] = None,
                           lmax: Optional[float] = None):
    """Communication-avoiding whole-mesh GMRES: one collective per s
    matvecs (``reductions='single'``; ``solvers/castep.py``).  The
    spectral interval defaults to the analytic whole-domain bounds."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.castep import (
        ca_gmres,
    )

    rows = _check_mesh(mesh, opcfg)
    if lmin is None or lmax is None:
        bounds = _analytic_bounds(opcfg)
        if bounds is None:
            raise ValueError(
                "ca_gmres needs lmin/lmax for this operator (analytic "
                "bounds are derived only for the Poisson stencils)")
        lmin, lmax = bounds
    lshape = (rows, opcfg.fdim)
    full_mv = make_full_mv(mesh, opcfg)
    bs = _shard_rhs(mesh, opcfg, b)
    nsh = mesh.nlocal
    res = ca_gmres(
        lambda v: full_mv(v.reshape(mesh.local_shape + lshape)).reshape(
            nsh, -1),
        bs.reshape(nsh, -1), s=s, maxiter=maxiter, rtol=rtol, atol=atol,
        lmin=lmin, lmax=lmax, reductions=reductions, axis_name=STRIP,
        mesh=mesh)
    return _first_result(mesh, opcfg, res, lshape)


# ---------------------------------------------------------------------------
# Multisplitting
# ---------------------------------------------------------------------------

def make_inner_solve(mesh, inner: InnerConfig, diag_mv, lshape, bounds_fn,
                     intra_axes, diag_val=None):
    """The per-block inner solve over ``intra_axes``, dispatched on
    ``inner.method`` (silently running another method than configured
    corrupts experiments); ``bounds_fn()`` gives the Chebyshev/CA-GMRES
    interval when the config names none; ``diag_val`` enables the scalar
    left-Jacobi scaling of a constant-diagonal stencil.  Fixed cycle
    counts keep the blocks in lockstep."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.castep import (
        ca_gmres,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
        chebyshev,
    )

    nsh = mesh.nlocal
    shape = mesh.local_shape + tuple(lshape)

    def mv(v):
        return diag_mv(v.reshape(shape)).reshape(nsh, -1)

    if inner.method in ("chebyshev", "ca_gmres") and inner.pc != "none":
        raise ValueError(f"{inner.method} inner solve does not compose "
                         f"with pc")
    if inner.method in ("chebyshev", "ca_gmres"):
        if inner.eig_min is not None and inner.eig_max is not None:
            lo, hi = inner.eig_min, inner.eig_max
        else:
            bounds = bounds_fn()
            if bounds is None:
                raise ValueError(f"{inner.method} needs eig bounds for this "
                                 f"operator")
            lo, hi = bounds
        if inner.method == "ca_gmres":
            def inner_solve(rhs, x):
                # one intra psum per inner.restart matvecs
                return ca_gmres(
                    mv, rhs.reshape(nsh, -1), x.reshape(nsh, -1),
                    s=inner.restart, maxiter=inner.maxiter, rtol=inner.rtol,
                    atol=inner.atol, lmin=lo, lmax=hi, axis_name=intra_axes,
                    mesh=mesh, fixed_cycles=True, reductions="single")
        else:
            def inner_solve(rhs, x):
                return chebyshev(mv, rhs.reshape(nsh, -1), x.reshape(nsh, -1),
                                 lmin=lo, lmax=hi, maxiter=inner.maxiter,
                                 axis_name=intra_axes, mesh=mesh)
        return inner_solve
    # left Jacobi: the stencil's diagonal is one constant, so D^-1 is one
    # scalar scale of operator and right-hand side
    dinv = (1.0 / diag_val if inner.pc == "jacobi" and diag_val is not None
            else 1.0)

    def inner_solve(rhs, x):
        return krylov.gmres(
            lambda v: dinv * mv(v), dinv * rhs.reshape(nsh, -1),
            x.reshape(nsh, -1), restart=inner.restart, maxiter=inner.maxiter,
            rtol=inner.rtol, atol=inner.atol, orthog=inner.orthog,
            axis_name=intra_axes, mesh=mesh, fixed_cycles=True,
            basis_dtype=inner.basis_dtype())

    return inner_solve


def check_schedule(schedule, minimization, staleness, nb):
    """``(is_async, publish periods)`` with JAX's errors."""
    if schedule not in ("sync", "async"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    is_async = schedule == "async"
    stal = ([int(staleness)] * nb if isinstance(staleness, int)
            else [int(v) for v in staleness])
    if len(stal) == 1:
        stal = stal * nb
    if len(stal) != nb:
        raise ValueError(f"staleness needs {nb} entries, got {len(stal)}")
    if not is_async and any(v != 1 for v in stal):
        raise ValueError("sync schedule requires staleness == 1")
    return is_async, stal


def run_spmd(mesh, body, bs, x0s, nb, record_history, unshard):
    """Run an SPMD body and assemble the ``MultisplitResult``."""
    (x, sweeps, cycles, inner_total, rnorm, rnorm0, block_norm, outer_rnorm,
     converged, hist) = body(bs, x0s)
    # the block norms are replicated within a block: gather them over
    # 'block' and keep the first shard's vector
    local_rnorms = mesh.local(mesh.all_gather(block_norm, "block"))
    return MultisplitResult(
        x=unshard(x), sweeps=sweeps, cycles=cycles, inner_iters=inner_total,
        rnorm=rnorm, rnorm0=rnorm0, local_rnorms=local_rnorms,
        outer_rnorm=outer_rnorm, converged=converged,
        history=hist if record_history else None)


def sharded_multisplit_solve(
    mesh,
    opcfg,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    rnorm0=None,
    schedule: str = "sync",
    staleness: Union[int, Sequence[int]] = 1,
    minimization: Optional[str] = None,
    s: int = 4,
    inner: InnerConfig = InnerConfig(),
    outer: OuterConfig = OuterConfig(),
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    record_history: bool = False,
    basis_collection: str = "sweep",
) -> MultisplitResult:
    """Sharded two-stage multisplitting over ``mesh ('block', 'intra')``.
    ``b`` is the global right-hand side in grid shape (every process
    passes the whole of it); ``x`` comes back global in grid shape.
    Parameters match ``models.multisplitting.multisplit_solve``."""
    nb = mesh.shape["block"]
    is_async, stal = check_schedule(schedule, minimization, staleness, nb)
    if minimization is None:
        s = 1
    rows = _check_mesh(mesh, opcfg)
    lshape = (rows, opcfg.fdim)
    dtype = b.dtype
    off = opcfg.off
    intra, cross = strip_halos(mesh)

    def diag_mv(g):
        """A_ii x_i on the local strips (intra halos only), halos first."""
        top, bot = intra(g)
        y = opcfg.interior_mv(g, panel=g.dim() > mesh.ndim + 2)
        return _add_rows(y, off, top, bot)

    def coupling_mv(g_vis):
        """A_ij x_j from the published peer-block state."""
        top, bot = cross(g_vis)
        return _add_rows(torch.zeros_like(g_vis), off, top, bot)

    _check_spmd_configs(inner, outer)
    inner_solve = make_inner_solve(
        mesh, inner, diag_mv, lshape, intra_axes=("intra",),
        diag_val=opcfg.diag, bounds_fn=lambda: _analytic_bounds(opcfg, nb))

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.engine import (
        make_spmd_body,
    )

    body = make_spmd_body(
        mesh=mesh, diag_mv=diag_mv, coupling_mv=coupling_mv,
        inner_solve=inner_solve, lshape=lshape, nb=nb, intra_axes=("intra",),
        all_axes=STRIP, is_async=is_async, stal=stal,
        minimization=minimization, s=s, outer=outer, rtol=rtol, atol=atol,
        maxiter=maxiter, min_convergence_count=min_convergence_count,
        dtype=dtype, record_history=record_history,
        basis_collection=basis_collection, pinned_rnorm0=rnorm0)
    bs = _shard_rhs(mesh, opcfg, b)
    x0s = (torch.zeros_like(bs) if x0 is None
           else _shard_rhs(mesh, opcfg, torch.as_tensor(x0, dtype=dtype)))
    return run_spmd(mesh, body, bs, x0s, nb, record_history,
                    lambda x: _unshard(mesh, opcfg, x))


__all__ = ["ShardedPoisson2D", "ShardedPoisson3D", "make_full_mv",
           "sharded_gmres_solve", "sharded_ca_gmres_solve",
           "sharded_multisplit_solve"]
