"""Sharded MG-PCG and double-float refinement: the multi-device north-star
(port of the JAX package's ``parallel/mgpcg.py``).

The single-device recipe (``solvers/multigrid.py`` + ``solvers/df64.py``:
multigrid-preconditioned f32 CG inside double-float refinement) laid out
over a mesh.  Every public function takes either the strip mesh
``('block', 'intra')`` (x-slab tiles, as ``parallel.sharded``) or the
tiled mesh ``('block', 'ir', 'ic')`` (perimeter halos, as
``parallel.tiled``), told apart by the mesh's axis names.  Tiles are
grid-shaped with the mesh dims leading: ``(nb, ni, lx, ny[, nz])`` or
``(nb, ir, ic, lx, ly[, nz])``.

* Stencil applies and Jacobi sweeps exchange one boundary plane per
  split axis by ``ppermute`` before the interior is computed; the interior
  is kernel A (3D: kind ``mv`` or ``jacobi``, one launch a tile) or kernel
  E (2D: every tile in one launch) with zero external halos, and the halo
  planes enter after it (linear in the taps: ``+off*halo`` for an apply,
  ``-omega*off*halo`` for a sweep).
* The cycle coarsens every axis by 2 while each tile keeps an even extent
  along each split axis, so restriction and prolongation are local
  (``multigrid._restrict``/``_prolong`` on the tile stack); the only
  communication in a level is the smoother's halos.
* At the distributed coarsest level the grid is gathered onto every
  process (coarse-grid agglomeration) and the single-device cycle
  (``multigrid.vcycle``: kernels A-C and M) continues on one copy, which
  is sliced back into tiles; the level hierarchy is then the
  single-device one at any shard count.
* PCG's dots reduce over all mesh axes (``krylov.cg`` with
  ``axis_name``); the refinement residuals are double-float on the tiles
  with the halo planes of both components exchanged first (plain
  PyTorch, as JAX's is plain jnp), so the mesh reaches 1e-8..1e-12
  relative residuals with f32 solves; only scalar norms are read.

JAX compiles each solve into one SPMD program; here the loops run on the
host, reading each PCG iteration's and each refinement pass's test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d import (
    stencil3d_apply,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    sharded as sh,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import (
    df64,
    krylov,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import (
    multigrid as mg,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    chebyshev,
)


def _grid_dims(opcfg) -> Tuple[int, ...]:
    if isinstance(opcfg, sh.ShardedPoisson2D):
        return (opcfg.m, opcfg.n)
    if isinstance(opcfg, sh.ShardedPoisson3D):
        return (opcfg.nx, opcfg.ny, opcfg.nz)
    raise TypeError(f"mgpcg supports ShardedPoisson2D/3D, got "
                    f"{type(opcfg).__name__}")


# ---------------------------------------------------------------------------
# Mesh layouts: strip ('block', 'intra') and tile ('block', 'ir', 'ic')
# ---------------------------------------------------------------------------

def _layout(mesh) -> str:
    names = tuple(mesh.axis_names)
    if names == ("block", "intra"):
        return "strip"
    if names == ("block", "ir", "ic"):
        return "tile"
    raise ValueError(f"mgpcg expects mesh axes ('block','intra') or "
                     f"('block','ir','ic'), got {names}")


def _axis_splits(mesh, nd: int) -> Tuple[int, ...]:
    """Shards along each grid axis."""
    if _layout(mesh) == "strip":
        return (mesh.shape["block"] * mesh.shape["intra"],) + (1,) * (nd - 1)
    if nd < 2:
        raise ValueError("tiled mesh needs a >=2-D grid")
    return ((mesh.shape["block"] * mesh.shape["ir"], mesh.shape["ic"])
            + (1,) * (nd - 2))


def _grid_spec(mesh):
    if _layout(mesh) == "strip":
        return (("block", "intra"),)
    return (("block", "ir"), "ic")


def _interior_jacobi(x, b, omega: float, nd: int, diag: float, off: float):
    """``x + omega (b - A_interior x)`` on each tile: kernel A kind
    ``jacobi`` a tile (3D), composed from kernel E (2D)."""
    if nd == 2:
        return x + omega * (b - sh.stack_apply(x, nd, diag, off))
    xs = x.reshape(-1, *x.shape[-3:])
    bs = b.reshape(-1, *b.shape[-3:])
    return torch.stack([stencil3d_apply(t.contiguous(), u.contiguous(),
                                        kind="jacobi", diag=diag, off=off,
                                        omega=omega)
                        for t, u in zip(xs, bs)]).reshape(x.shape)


def _make_halo_mv(mesh, diag: float, off: float, nd: int):
    """``(halo_mv, halos, halo_sweep)`` on tile stacks: ``halo_mv(g)`` is
    the whole-mesh stencil; ``halos(g)`` gives, per split grid axis, the
    ``(lo, hi)`` neighbour boundary planes; ``halo_sweep(x, b, omega)``
    the damped-Jacobi sweep with its halo fixup ``-omega*off*halo``.  The
    neighbour pairing is the same at every level."""
    k = mesh.ndim
    if _layout(mesh) == "strip":
        intra, cross = sh.strip_halos(mesh)
        lead_dims = (k,)

        def halos(g):
            # the rows axis of the strip helpers is -2: view each tile
            # as (lx, rest) there
            flat = g.reshape(g.shape[:k + 1] + (-1,))
            ti, bi = intra(flat)
            tb, bb = cross(flat)
            rest = g.shape[k + 1:]
            return (((ti + tb).reshape(g.shape[:k] + rest),
                     (bi + bb).reshape(g.shape[:k] + rest)),)
    else:
        intra, cross = sh.strip_halos(mesh, lead="ir")
        pc = mesh.shape["ic"]
        c_up, c_dn = sh._pairs(pc)
        lead_dims = (k, k + 1)

        def halos(g):
            flat = g.reshape(g.shape[:k + 1] + (-1,))
            ni, si = intra(flat)
            nc, sc = cross(flat)
            rest = g.shape[k + 1:]
            north = (ni + nc).reshape(g.shape[:k] + rest)
            south = (si + sc).reshape(g.shape[:k] + rest)
            west = mesh.ppermute(g.select(k + 1, -1), "ic", c_up)
            east = mesh.ppermute(g.select(k + 1, 0), "ic", c_dn)
            return ((north, south), (west, east))

    def fix(y, hs, coef):
        for d, (lo, hi) in zip(lead_dims, hs):
            y.select(d, 0).add_(coef * lo)
            y.select(d, -1).add_(coef * hi)
        return y

    def halo_mv(g):
        hs = halos(g)
        return fix(sh.stack_apply(g, nd, diag, off), hs, off)

    def halo_sweep(x, b, omega):
        hs = halos(x)
        w = _round(omega, x.dtype)
        y = _interior_jacobi(x, b, w, nd, diag, off)
        return fix(y, hs, -_round(w * _round(off, x.dtype), x.dtype))

    return halo_mv, halos, halo_sweep


def _round(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (JAX's ``jnp.asarray(v, dtype)``)."""
    return torch.tensor(v, dtype=dtype).item()


# ---------------------------------------------------------------------------
# Level plan + distributed V-cycle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedMGPlan:
    """Static cycle description: each level's GLOBAL grid dims and the
    shards along each grid axis (local dims = ``dims[i] // splits[i]``)."""

    dims: Tuple[Tuple[int, ...], ...]
    diag: float
    off: float
    nu: int
    coarse_iters: int
    splits: Tuple[int, ...]
    agglomerate: bool = True
    min_size: int = 4
    cycle: str = "w"  # 'w' | 'v'

    def local(self, level: int) -> Tuple[int, ...]:
        return tuple(d // s for d, s in zip(self.dims[level], self.splits))


def plan_sharded(opcfg, splits, *, nu: int = 2, min_size: int = 4,
                 coarse_iters: int = 40, agglomerate: bool = True,
                 cycle: str = "w") -> ShardedMGPlan:
    """Coarsen while each tile keeps an even extent along every split axis
    (so restriction stays local) and the unsplit dims stay even and at
    least ``min_size``.  ``splits``: shards per grid axis (an int: the
    leading axis).  ``agglomerate``: continue below the distributed
    coarsest level on a gathered copy (``_sharded_vcycle``)."""
    if cycle not in ("v", "w"):
        raise ValueError(f"cycle must be 'v' or 'w', got {cycle!r}")
    dims = _grid_dims(opcfg)
    if isinstance(splits, int):
        splits = (splits,) + (1,) * (len(dims) - 1)
    splits = tuple(splits)
    for ax, (d, s) in enumerate(zip(dims, splits)):
        if d % s:
            raise ValueError(f"grid axis {ax} extent {d} not divisible by "
                             f"{s} devices")
    levels = [dims]
    while True:
        d = levels[-1]
        stop = False
        for n, s in zip(d, splits):
            if s > 1:
                loc = n // s
                if loc % 2 or loc < 2:
                    stop = True
            elif n % 2 or n // 2 < min_size:
                stop = True
        if stop:
            break
        levels.append(tuple(n // 2 for n in d))
    return ShardedMGPlan(
        dims=tuple(levels), diag=float(opcfg.diag), off=float(opcfg.off),
        nu=nu, coarse_iters=coarse_iters, splits=splits,
        agglomerate=agglomerate, min_size=min_size, cycle=cycle)


def _make_agglomerator(mesh, splits: Tuple[int, ...]):
    """``(gather, slice_local)``: a distributed grid gathered whole (one
    copy, on every process), and a whole grid cut back into this
    process's tiles, in the tile ownership order of the mesh.  The gather
    is JAX's: ``all_gather`` over the leading owners ('block' with
    'intra' or 'ir'), then, tiled, over 'ic' (mesh-axis-major order is
    the tile ownership order)."""
    spec = _grid_spec(mesh)

    def gather(g, dims):
        full = mesh.all_gather(g, spec[0], axis=0, tiled=True)
        if len(spec) > 1:
            full = mesh.all_gather(full, spec[1], axis=1, tiled=True)
        return mesh.local(full).reshape(dims)

    def slice_local(full):
        return mesh.shard(full, spec)

    return gather, slice_local


def _cycle_precond(plan: ShardedMGPlan, halo_mv, agg, halo_sweep) -> Callable:
    """The cycle as a CG preconditioner, in bf16 when the local level-0
    tile exceeds ``multigrid._BF16_CYCLE_BYTES`` in f32 (the single-device
    rule)."""
    bf16 = 4 * math.prod(plan.local(0)) > mg._BF16_CYCLE_BYTES

    def M(r: torch.Tensor) -> torch.Tensor:
        if bf16:
            z = _sharded_vcycle(plan, halo_mv, r.to(torch.bfloat16), agg=agg,
                                halo_sweep=halo_sweep)
            return z.to(r.dtype)
        return _sharded_vcycle(plan, halo_mv, r, agg=agg,
                               halo_sweep=halo_sweep)

    return M


def _sharded_vcycle(plan: ShardedMGPlan, halo_mv, b: torch.Tensor,
                    level: int = 0, agg=None, halo_sweep=None):
    """One V(nu, nu) or W cycle from the zero guess on the tile stack
    ``b``.  At the coarsest level, with ``agg``, the grid is gathered and
    the single-device cycle continues on it (``multigrid.vcycle``), then
    each tile of the correction is cut back out; without it, Chebyshev
    under the analytic Dirichlet bounds (no reductions)."""
    dims = plan.dims[level]
    nd = len(dims)
    dtype = b.dtype
    omega = _round(mg._JACOBI_OMEGA[nd] / plan.diag, dtype)

    if level == len(plan.dims) - 1:
        if agg is not None:
            gather, slice_local = agg
            full = gather(b, dims)
            sub = mg.plan(mg._make_op(dims, plan.diag, plan.off), nu=plan.nu,
                          min_size=plan.min_size,
                          coarse_iters=plan.coarse_iters, cycle=plan.cycle)
            return slice_local(mg.vcycle(sub, full.contiguous()))
        lmin, lmax = mg._dirichlet_bounds(dims, plan.diag, plan.off)
        return chebyshev(halo_mv, b, maxiter=plan.coarse_iters, lmin=lmin,
                         lmax=lmax).x

    smooth = (halo_sweep if halo_sweep is not None
              else (lambda x_, b_, w: x_ + w * (b_ - halo_mv(x_))))
    x = omega * b
    for _ in range(plan.nu - 1):
        x = smooth(x, b, omega)
    r = b - halo_mv(x)
    # (2h)^2 / h^2 rescaling of the h^2-convention residual
    rc = 4.0 * mg._restrict(r, plan.local(level))
    ec = _sharded_vcycle(plan, halo_mv, rc, level + 1, agg, halo_sweep)
    if plan.cycle == "w" and level + 1 < len(plan.dims) - 1:
        ec = ec + _sharded_vcycle(plan, halo_mv, rc - halo_mv(ec), level + 1,
                                  agg, halo_sweep)
    x = x + mg._prolong(ec, plan.local(level + 1)).to(dtype)
    for _ in range(plan.nu):
        x = smooth(x, b, omega)
    return x


# ---------------------------------------------------------------------------
# MG-PCG
# ---------------------------------------------------------------------------

def _pieces(mesh, opcfg, nu, min_size, coarse_iters, cycle):
    dims = _grid_dims(opcfg)
    plan = plan_sharded(opcfg, _axis_splits(mesh, len(dims)), nu=nu,
                        min_size=min_size, coarse_iters=coarse_iters,
                        cycle=cycle)
    halo_mv, halos, halo_sweep = _make_halo_mv(mesh, plan.diag, plan.off,
                                               len(dims))
    agg = _make_agglomerator(mesh, plan.splits) if plan.agglomerate else None
    return plan, halo_mv, halos, halo_sweep, agg


def _sharded_cg(mesh, plan, halo_mv, halo_sweep, agg, r, **kw):
    """``krylov.cg`` on the tile stack ``r``, MG-preconditioned, every dot
    reduced over the whole mesh."""
    shape = r.shape
    nsh = mesh.nlocal
    M = _cycle_precond(plan, halo_mv, agg, halo_sweep)
    return krylov.cg(
        lambda v: halo_mv(v.reshape(shape)).reshape(nsh, -1),
        r.reshape(nsh, -1), axis_name=tuple(mesh.axis_names), mesh=mesh,
        precond=lambda v: M(v.reshape(shape)).reshape(nsh, -1), **kw)


def sharded_mgpcg_solve(mesh, opcfg, b: torch.Tensor, *, rtol: float = 1e-5,
                        atol: float = 0.0, maxiter: int = 100, nu: int = 2,
                        min_size: int = 4, coarse_iters: int = 40,
                        cycle: str = "w"):
    """Whole-mesh multigrid-preconditioned CG (true-residual test): the
    sharded ``cg(op.mv, b, precond=mg_preconditioner(op))``.  ``b`` is the
    global grid; ``x`` comes back global.  Strip and tiled meshes."""
    plan, halo_mv, _, halo_sweep, agg = _pieces(mesh, opcfg, nu, min_size,
                                                coarse_iters, cycle)
    spec = _grid_spec(mesh)
    bs = mesh.shard(b, spec)
    res = _sharded_cg(mesh, plan, halo_mv, halo_sweep, agg, bs,
                      maxiter=maxiter, rtol=rtol, atol=atol)
    x = mesh.unshard(res.x.reshape(bs.shape), spec, tuple(b.shape))
    return krylov.KrylovResult(
        x=x, iters=res.iters[0], resnorm=res.resnorm[0],
        resnorm0=res.resnorm0[0], converged=res.converged[0],
        syncs=res.syncs)


# ---------------------------------------------------------------------------
# Double-float residuals on the mesh
# ---------------------------------------------------------------------------

def _df_tile_residual(mesh, b_df, x_df, axis_halos, diag: float, off: float):
    """``b - A x`` in double-float on each tile, the neighbour planes of
    both components written into the zero padding first (``axis_halos``:
    ``(grid axis, (lo_hi, lo_lo), (hi_hi, hi_lo))``), then the pairwise
    two-sum tree of ``df64.stencil3d_df_residual``, so boundary rows get
    the interior's ~2^-48 accuracy (the corners stay zero: a 5/7-point
    stencil has no diagonal taps)."""
    xhi, xlo = x_df
    k = mesh.ndim
    nd = xhi.dim() - k

    def with_halos(g, comp: int):
        p = F.pad(g, (1, 1) * nd)
        inner = [slice(None)] * k + [slice(1, -1)] * nd
        for axis, lo_df, hi_df in axis_halos:
            lo_idx, hi_idx = list(inner), list(inner)
            lo_idx[k + axis], hi_idx[k + axis] = 0, -1
            p[tuple(lo_idx)] = lo_df[comp]
            p[tuple(hi_idx)] = hi_df[comp]
        return p

    phi = with_halos(xhi, 0)
    plo = with_halos(xlo, 1)

    def tap_pair(p, ax):
        lo = [slice(None)] * k + [slice(1, -1)] * nd
        hi = list(lo)
        lo[k + ax], hi[k + ax] = slice(0, -2), slice(2, None)
        return p[tuple(lo)], p[tuple(hi)]

    nh = None
    err = 0.0
    for ax in range(nd):
        a, bb = tap_pair(phi, ax)
        s, e = df64.two_sum(a, bb)
        err = err + e
        if nh is None:
            nh = s
        else:
            nh, e2 = df64.two_sum(nh, s)
            err = err + e2
    lo_taps = 0.0
    for ax in range(nd):
        a, bb = tap_pair(plo, ax)
        lo_taps = lo_taps + a + bb
    nl = err + lo_taps
    ndf = df64._df_combine(nh, nl, off)
    ddf = df64._int_coeff_mul(xhi, diag)
    ddf = df64.df_add_f32(ddf, _round(diag, torch.float32) * xlo)
    ax_ = df64.df_add(ddf, ndf)
    return df64.df_add(b_df, df64.df_neg(ax_))


def _df_residual_pass(mesh, halos, diag, off):
    """``(bhi, blo, xhi, xlo) -> (rhi, rlo, ||rhi||)``: the halos of both
    components exchanged (one (lo, hi) pair per layout axis), the tile
    residual, the f32-safe norm over the mesh."""
    axes = tuple(mesh.axis_names)

    def run(bhi, blo, xhi, xlo):
        hh, hl = halos(xhi), halos(xlo)
        axis_halos = tuple((axis, (a[0], c[0]), (a[1], c[1]))
                           for axis, (a, c) in enumerate(zip(hh, hl)))
        rhi, rlo = _df_tile_residual(mesh, (bhi, blo), (xhi, xlo),
                                     axis_halos, diag, off)
        return rhi, rlo, mesh.local(df64.scaled_norm(rhi, axes, mesh))

    return run


def _apply_correction(xhi, xlo, d32, scale):
    upd = df64.df_mul_f32((d32, torch.zeros_like(d32)), scale)
    return df64.df_add((xhi, xlo), upd)


def sharded_df_refine(mesh, opcfg, solve_f32: Callable, b_df, *,
                      rtol: float = 1e-8, max_passes: int = 6):
    """Double-float iterative refinement on the mesh.  ``solve_f32(r) ->
    d`` is any f32 approximate solve on tile stacks (e.g. the sharded
    MG-PCG); ``b_df = (bhi, blo)`` are f32 tile stacks.  The residual and
    its norm run on the tiles (halo planes of both components exchanged
    first); only scalar norms reach the host.  Returns
    ``solvers.refine.RefineResult`` with ``x`` the global (hi, lo) pair."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
        RefineResult,
    )

    _, halos, _ = _make_halo_mv(mesh, float(opcfg.diag), float(opcfg.off),
                                len(_grid_dims(opcfg)))
    residual = _df_residual_pass(mesh, halos, float(opcfg.diag),
                                 float(opcfg.off))
    spec, gshape = _grid_spec(mesh), _grid_dims(opcfg)
    bhi, blo = b_df
    xhi, xlo = torch.zeros_like(bhi), torch.zeros_like(blo)

    def result(passes, hist, rn, rn0, ok, syncs):
        x = (mesh.unshard(xhi, spec, gshape), mesh.unshard(xlo, spec, gshape))
        return RefineResult(x, passes, hist, rn, rn0, ok, syncs=syncs)

    # x0 = 0 makes r = b: ||b|| is the first residual norm
    rnorm0 = float(mesh.local(df64.scaled_norm(bhi, tuple(mesh.axis_names),
                                               mesh)))
    if rnorm0 == 0.0:
        return result(0, [], 0.0, 0.0, True, 1)
    history, syncs = [], 1
    rhi, rnorm = bhi, rnorm0
    for p in range(max_passes):
        if p > 0:
            rhi, _rlo, rn = residual(bhi, blo, xhi, xlo)
            rnorm = float(rn)
            syncs += 1
        rel = rnorm / rnorm0
        history.append(rel)
        if rel <= rtol:
            return result(p, history, rnorm, rnorm0, True, syncs)
        scale = torch.tensor(rnorm, dtype=torch.float32, device=bhi.device)
        d32 = solve_f32(rhi / scale)
        xhi, xlo = _apply_correction(xhi, xlo, d32, scale)
    rhi, _rlo, rn = residual(bhi, blo, xhi, xlo)
    rnorm = float(rn)
    history.append(rnorm / rnorm0)
    return result(max_passes, history, rnorm, rnorm0,
                  rnorm / rnorm0 <= rtol, syncs + 1)


def _northstar_rhs(mesh, plan, halo_mv):
    """``b = A 1`` on the mesh (exact small integers in f32)."""
    ones = torch.ones(mesh.local_shape + plan.local(0), dtype=torch.float32,
                      device=mesh.device)
    return halo_mv(ones)


def sharded_df_northstar(mesh, opcfg, *, rtol: float = 1e-8,
                         inner_rtol: float = 1e-5, pcg_maxiter: int = 40,
                         max_passes: int = 6, nu: int = 2, min_size: int = 4,
                         coarse_iters: int = 40, cycle: str = "w"):
    """The multi-device north-star: ``A x = b`` with ``b = A 1`` built on
    the mesh, to ``rtol`` relative TRUE residual by sharded MG-PCG inside
    double-float refinement.  Returns the ``RefineResult`` (``x`` the
    global df pair).  Strip and tiled meshes."""
    plan, halo_mv, _, halo_sweep, agg = _pieces(mesh, opcfg, nu, min_size,
                                                coarse_iters, cycle)

    def pcg(r):
        return _sharded_cg(mesh, plan, halo_mv, halo_sweep, agg, r,
                           maxiter=pcg_maxiter, rtol=inner_rtol).x.reshape(
                               r.shape)

    bhi = _northstar_rhs(mesh, plan, halo_mv)
    return sharded_df_refine(mesh, opcfg, pcg, (bhi, torch.zeros_like(bhi)),
                             rtol=rtol, max_passes=max_passes)


def sharded_df_northstar_fused(mesh, opcfg, *, rtol: float = 1e-8,
                               inner_rtol: float = 1e-5,
                               pcg_maxiter: int = 40, max_passes: int = 6,
                               nu: int = 2, min_size: int = 4,
                               coarse_iters: int = 40, cycle: str = "w"):
    """The north-star with its pass loop's test on the device (JAX's one
    SPMD program, ``lax.while_loop`` over the passes): the residual norm
    stays a tensor, the correction scale is never rounded through the
    host, and one flag is read per pass.  The same result contract as
    ``sharded_df_northstar`` without the per-pass history; ``pcg_iters``
    holds each pass's PCG count."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
        RefineResult,
    )

    plan, halo_mv, halos, halo_sweep, agg = _pieces(mesh, opcfg, nu,
                                                    min_size, coarse_iters,
                                                    cycle)
    residual = _df_residual_pass(mesh, halos, plan.diag, plan.off)
    axes = tuple(mesh.axis_names)
    bhi = _northstar_rhs(mesh, plan, halo_mv)
    blo = torch.zeros_like(bhi)
    rnorm0 = mesh.local(df64.scaled_norm(bhi, axes, mesh))
    tol = rtol * rnorm0
    xhi, xlo = torch.zeros_like(bhi), torch.zeros_like(bhi)
    rhi, rnorm, passes, iters, syncs = bhi, rnorm0, 0, [], 0
    while passes < max_passes:
        syncs += 1
        if not bool(rnorm > tol):
            break
        res = _sharded_cg(mesh, plan, halo_mv, halo_sweep, agg, rhi / rnorm,
                          maxiter=pcg_maxiter, rtol=inner_rtol)
        iters.append(int(res.iters[0]))
        syncs += res.syncs
        xhi, xlo = _apply_correction(xhi, xlo, res.x.reshape(bhi.shape),
                                     rnorm)
        rhi, _rlo, rnorm = residual(bhi, blo, xhi, xlo)
        passes += 1
    spec, gshape = _grid_spec(mesh), _grid_dims(opcfg)
    rn, rn0 = float(rnorm), float(rnorm0)
    return RefineResult(
        (mesh.unshard(xhi, spec, gshape), mesh.unshard(xlo, spec, gshape)),
        passes, [], rn, rn0, rn <= rtol * rn0, pcg_iters=iters, syncs=syncs)
