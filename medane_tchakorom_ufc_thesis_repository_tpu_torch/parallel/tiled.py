"""2D- and 3D-tiled sharded multisplitting on the mesh ``('block', 'ir',
'ic')`` (port of the JAX package's ``parallel/tiled.py``).

Each Jacobi block's band is tiled in two directions:

* ``'block'``: Jacobi blocks (leading-axis bands, as always);
* ``'ir'``: leading-axis tiles within a block;
* ``'ic'``: second-axis tiles (shared by all blocks).

Halos (5/7-point stencils need no corners): the leading axis exchanges
over 'ir' inside a block, and block-boundary slices take the wrap +
'block'-shift two steps of ``parallel.sharded``; the second axis
exchanges over 'ic' (blocks split the leading axis only, as in the
reference); the third axis (3D) is local.  A P-device strip split moves
O(cross-section) per device per sweep, a (Pr x Pc) tiling O(perimeter).

The solver loop is ``parallel.engine``'s.  The tile applies are kernel E
(2D, every tile of the stack in one launch) and kernel A kind ``mv`` (3D,
one launch a tile).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
    MultisplitResult,
    OuterConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.engine import (
    make_spmd_body,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.mesh import Mesh
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.sharded import (
    _check_spmd_configs,
    _pairs,
    check_schedule,
    make_inner_solve,
    run_spmd,
    stack_apply,
    strip_halos,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    poisson_strip_eig_bounds_2d,
    poisson_strip_eig_bounds_3d,
)

TILE = ("block", "ir", "ic")
INTRA = ("ir", "ic")


def make_tiled_mesh(nblocks: int = 2, ir: int = 2, ic: int = 2, *,
                    transport: str = "local", device=None) -> Mesh:
    """A ``('block', 'ir', 'ic')`` mesh on ``transport`` (see
    ``parallel.mesh.make_mesh``)."""
    return Mesh(TILE, (nblocks, ir, ic), transport=transport, device=device)


def _tile_fns(mesh, nd: int, diag: float, off: float):
    """``(intra, cross, add_lead, add_second)`` on tiles ``(..., a, b[,
    nz])`` whose leading axes are the mesh dims (and an optional basis
    axis): the halos within a block and from the neighbouring blocks, and
    the fixups that add ``off`` times them on the two split axes."""
    pc = mesh.shape["ic"]
    c_up, c_dn = _pairs(pc)
    lead_halos, cross_halos = strip_halos(mesh, lead="ir")
    # the lead-axis helpers of parallel.sharded take the rows axis at -2;
    # in 3D it is -3, so move the z axis out of the way first
    def second(g, i):
        return g[..., :, i] if nd == 2 else g[..., :, i, :]

    def lead(g):
        return g if nd == 2 else g.movedim(-1, -3)

    def unlead(t):
        return t if nd == 2 else t.movedim(-2, -1)

    def intra(g):
        north, south = lead_halos(lead(g))
        west = mesh.ppermute(second(g, -1), "ic", c_up)
        east = mesh.ppermute(second(g, 0), "ic", c_dn)
        return unlead(north), unlead(south), west, east

    def cross(g):
        north, south = cross_halos(lead(g))
        return unlead(north), unlead(south)

    def add_lead(y, top, bot):
        if nd == 2:
            y[..., 0, :] += off * top
            y[..., -1, :] += off * bot
        else:
            y[..., 0, :, :] += off * top
            y[..., -1, :, :] += off * bot
        return y

    def add_second(y, west, east):
        if nd == 2:
            y[..., :, 0] += off * west
            y[..., :, -1] += off * east
        else:
            y[..., :, 0, :] += off * west
            y[..., :, -1, :] += off * east
        return y

    return intra, cross, add_lead, add_second


def _check_tiles(mesh, dims):
    if tuple(mesh.axis_names) != TILE:
        raise ValueError(f"expected a {TILE} mesh, got {mesh.axis_names}")
    nb, pr, pc = (mesh.shape[a] for a in TILE)
    if dims[0] % (nb * pr) or dims[1] % pc:
        raise ValueError(
            f"grid {'x'.join(map(str, dims))} not divisible by "
            f"({nb}*{pr}) x {pc} tiles")
    return (dims[0] // (nb * pr), dims[1] // pc) + tuple(dims[2:])


def _tiled_solve(mesh, dims, b, *, diag, off, schedule, staleness,
                 minimization, s, inner, outer, rtol, atol, maxiter,
                 min_convergence_count, record_history, basis_collection,
                 bounds_fn) -> MultisplitResult:
    _check_spmd_configs(inner, outer)
    nb = mesh.shape["block"]
    is_async, stal = check_schedule(schedule, minimization, staleness, nb)
    if minimization is None:
        s = 1
    lshape = _check_tiles(mesh, dims)
    if tuple(b.shape) != tuple(dims):
        raise ValueError(f"b must be {tuple(dims)}, got {tuple(b.shape)}")
    nd = len(dims)
    intra, cross, add_lead, add_second = _tile_fns(mesh, nd, diag, off)

    def diag_mv(g):
        # halos first, the interior, then the halos consumed
        nh, sh, wh, eh = intra(g)
        y = stack_apply(g, nd, diag, off, panel=g.dim() > mesh.ndim + nd)
        return add_second(add_lead(y, nh, sh), wh, eh)

    def coupling_mv(g_vis):
        nh, sh = cross(g_vis)
        return add_lead(torch.zeros_like(g_vis), nh, sh)

    inner_solve = make_inner_solve(mesh, inner, diag_mv, lshape,
                                   bounds_fn=bounds_fn, intra_axes=INTRA,
                                   diag_val=diag)
    body = make_spmd_body(
        mesh=mesh, diag_mv=diag_mv, coupling_mv=coupling_mv,
        inner_solve=inner_solve, lshape=lshape, nb=nb, intra_axes=INTRA,
        all_axes=TILE, is_async=is_async, stal=stal,
        minimization=minimization, s=s, outer=outer, rtol=rtol, atol=atol,
        maxiter=maxiter, min_convergence_count=min_convergence_count,
        dtype=b.dtype, record_history=record_history,
        basis_collection=basis_collection)
    spec = (("block", "ir"), "ic")
    bs = mesh.shard(b, spec)
    return run_spmd(mesh, body, bs, torch.zeros_like(bs), nb, record_history,
                    lambda x: mesh.unshard(x, spec, tuple(dims)))


def tiled_multisplit_solve(
    mesh,
    m: int,
    n: int,
    b: torch.Tensor,
    *,
    diag: float = 4.0,
    off: float = -1.0,
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
    """2D Poisson multisplitting over a ``('block', 'ir', 'ic')`` mesh;
    ``b`` is the global right-hand side in grid shape ``(m, n)``."""
    nb = mesh.shape["block"]
    return _tiled_solve(
        mesh, (m, n), b, diag=diag, off=off, schedule=schedule,
        staleness=staleness, minimization=minimization, s=s, inner=inner,
        outer=outer, rtol=rtol, atol=atol, maxiter=maxiter,
        min_convergence_count=min_convergence_count,
        record_history=record_history, basis_collection=basis_collection,
        bounds_fn=lambda: poisson_strip_eig_bounds_2d(m // nb, n, diag, off))


def tiled_multisplit_solve_3d(
    mesh,
    nx: int,
    ny: int,
    nz: int,
    b: torch.Tensor,
    *,
    diag: float = 6.0,
    off: float = -1.0,
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
    """3D Poisson multisplitting: x-planes over ('block', 'ir'), y over
    'ic', z local; ``b`` in grid shape ``(nx, ny, nz)``."""
    nb = mesh.shape["block"]
    return _tiled_solve(
        mesh, (nx, ny, nz), b, diag=diag, off=off, schedule=schedule,
        staleness=staleness, minimization=minimization, s=s, inner=inner,
        outer=outer, rtol=rtol, atol=atol, maxiter=maxiter,
        min_convergence_count=min_convergence_count,
        record_history=record_history, basis_collection=basis_collection,
        bounds_fn=lambda: poisson_strip_eig_bounds_3d(nx // nb, ny, nz, diag,
                                                      off))


def _tiled_gmres(mesh, dims, b, *, diag, off, restart, maxiter, rtol, atol,
                 orthog):
    lshape = _check_tiles(mesh, dims)
    nd = len(dims)
    intra, cross, add_lead, add_second = _tile_fns(mesh, nd, diag, off)

    def full_mv(g):
        nh, sh, wh, eh = intra(g)
        cn, cs = cross(g)
        y = stack_apply(g, nd, diag, off)
        return add_second(add_lead(y, nh + cn, sh + cs), wh, eh)

    spec = (("block", "ir"), "ic")
    bs = mesh.shard(b.reshape(dims), spec)
    nsh = mesh.nlocal
    res = krylov.gmres(
        lambda v: full_mv(v.reshape(bs.shape)).reshape(nsh, -1),
        bs.reshape(nsh, -1), restart=restart, maxiter=maxiter, rtol=rtol,
        atol=atol, orthog=orthog, axis_name=TILE, mesh=mesh)
    x = mesh.unshard(res.x.reshape(bs.shape), spec, tuple(dims))
    return krylov.KrylovResult(
        x=x, iters=res.iters[0], resnorm=res.resnorm[0],
        resnorm0=res.resnorm0[0], converged=res.converged[0],
        syncs=res.syncs)


def tiled_gmres_solve(mesh, m: int, n: int, b: torch.Tensor, *,
                      diag: float = 4.0, off: float = -1.0, restart: int = 30,
                      maxiter: int = 10000, rtol: float = 1e-5,
                      atol: float = 0.0, orthog: str = "cgs2"):
    """Whole-system GMRES over the 2D-tiled mesh (the ``gmres_solution``
    baseline, reference ``gmres_solution.c:58-91``, with perimeter
    halos); reductions over all three axes."""
    return _tiled_gmres(mesh, (m, n), b, diag=diag, off=off, restart=restart,
                        maxiter=maxiter, rtol=rtol, atol=atol, orthog=orthog)


def tiled_gmres_solve_3d(mesh, nx: int, ny: int, nz: int, b: torch.Tensor, *,
                         diag: float = 6.0, off: float = -1.0,
                         restart: int = 30, maxiter: int = 10000,
                         rtol: float = 1e-5, atol: float = 0.0,
                         orthog: str = "cgs2"):
    """The 3D ``tiled_gmres_solve``: x-planes over ('block', 'ir'), y over
    'ic', z local."""
    return _tiled_gmres(mesh, (nx, ny, nz), b, diag=diag, off=off,
                        restart=restart, maxiter=maxiter, rtol=rtol,
                        atol=atol, orthog=orthog)
