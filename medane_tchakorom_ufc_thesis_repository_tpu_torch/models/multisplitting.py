"""Two-stage multisplitting solvers with optional s-step minimization (port
of the JAX package's ``models/multisplitting.py``).

One driver, ``multisplit_solve``, covers the eight reference binaries:

=================  ==========  ============  ====================
reference binary   schedule    minimization  termination
=================  ==========  ============  ====================
SM                 sync        none          global true-residual
AM                 async       none          persistence counters
SMSM_LOCAL         sync        'local'       per-block handshake
SMSM_SEMI_LOCAL    sync        'semi_local'  per-block handshake
SMSM_GLOBAL        sync        'global'      outer LS residual
AMAM_*             async       as above      persistence counters
=================  ==========  ============  ====================

Block state is stacked ``(nblocks, block_size)`` and the per-block inner
solves run as one batched solve (the JAX package's ``vmap``).
Asynchrony is bounded staleness: block ``b`` publishes its iterate to its
peers every ``staleness[b]`` sweeps, and an async run ends with a
synchronous certification tail on the true coupling.

JAX compiles the whole solve into one program.  Here the loops run on the
host; every decision that depends only on counts (sweeps, publish
schedules, basis slots) is taken there with no device read, and the
device is read once before the first outer cycle, once per outer cycle
(the convergence flag), once per certification round, and inside the
inner and outer solves as they document (``MultisplitResult.syncs``
counts them all).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
    BlockOperator,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.fused import maxpy
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.bjacobi import (
    BlockJacobi,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    chebyshev,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lsqr import cgne, lsqr
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
    lstsq_normal,
    lstsq_qr,
)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InnerConfig:
    """Inner (per-block) solve, the analog of the reference's
    ``inner1_``/``inner2_`` KSP (gmres, maxit 20, rtol 1e-3, pc none;
    ``config/default_run_variables:36-44``).

    ``method``: 'gmres', 'cg', 'bicgstab', 'chebyshev' or 'ca_gmres'
    (s-step GMRES with ``s = restart``, one Gram matrix per cycle).
    ``pc``: 'none', 'jacobi' (left diagonal scaling by each block's own
    diagonal), 'mg' (one multigrid cycle on the strip's diagonal block,
    ``solvers/multigrid.py``; stencil strips) or 'bjacobi' (the inverses
    of each ``A_ii``'s ``pc_block_size`` diagonal sub-blocks; the stacked
    ELL/DIA/BSR operators).  With 'gmres' a pc is PETSc's default left
    preconditioning; 'cg' and 'bicgstab' take 'mg' and 'bjacobi' as a
    true-residual preconditioner; 'chebyshev' and 'ca_gmres' take none.
    ``basis``: 'native' or 'bf16' Krylov-basis storage.
    ``eig_min``/``eig_max``: the spectral bounds of 'chebyshev' and
    'ca_gmres' (default: the operator's analytic ``diag_eig_bounds()``,
    else a Lanczos estimate over the blocks).
    """

    restart: int = 30
    maxiter: int = 20
    rtol: float = 1e-3
    atol: float = 0.0
    orthog: str = "cgs2"
    method: str = "gmres"
    pc: str = "none"
    pc_block_size: int = 64   # 'bjacobi' diagonal-sub-block size
    basis: str = "native"
    eig_min: Optional[float] = None
    eig_max: Optional[float] = None

    def basis_dtype(self) -> Optional[torch.dtype]:
        if self.basis == "native":
            return None
        if self.basis == "bf16":
            return torch.bfloat16
        raise ValueError(f"unknown basis {self.basis!r}")


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    """Outer (minimization) least-squares solve, the analog of the
    ``outer1_``/``outer2_`` KSP (``default_run_variables:54-66``).
    ``method``: 'qr' (tall-skinny QR, default), 'normal' (Gram +
    Cholesky), 'lsqr' or 'cgne' (iterative, reference parity)."""

    method: str = "qr"
    maxiter: int = 100
    rtol: float = 1e-12
    atol: float = 0.0
    damping: float = 0.0
    alpha_average: bool = False  # the reference's *_modify alpha exchange


@dataclasses.dataclass(frozen=True)
class MultisplitResult:
    """Stacked solver output.  Counts and flags that the host loop decides
    are Python values; measured norms stay tensors on the solve's
    device."""

    x: torch.Tensor               # (nblocks, block_size)
    sweeps: int                   # multisplitting sweeps, tail included
    cycles: int                   # outer cycles (minimization rounds)
    inner_iters: torch.Tensor     # inner iterations, all blocks (0-d)
    rnorm: torch.Tensor           # last measured global residual norm
    rnorm0: torch.Tensor          # reference norm of the convergence test
    local_rnorms: torch.Tensor    # (nblocks,) last per-block residual norms
    outer_rnorm: torch.Tensor     # last outer LS residual
    converged: bool
    history: Optional[torch.Tensor] = None   # per-cycle rnorms, inf unreached
    # async runs only: True when the returned x was re-verified on the
    # true coupling (||b - A x|| <= rtol ||r0|| per block); None on sync
    certified: Optional[bool] = None
    tail_sweeps: Optional[int] = None        # sweeps of the async tail
    syncs: int = 0                           # host reads of device values


# ---------------------------------------------------------------------------
# Inner solve (one batched solve over the blocks)
# ---------------------------------------------------------------------------

def _per_block(cfg, nb: int, what: str):
    """``(uniform_cfg, None)`` when one config applies to every block,
    ``(None, configs)`` when blocks differ (the reference's
    ``inner1_``/``inner2_`` per-rank prefixes)."""
    if isinstance(cfg, (list, tuple)):
        if len(cfg) != nb:
            raise ValueError(
                f"per-block {what} needs {nb} entries, got {len(cfg)}")
        if all(c == cfg[0] for c in cfg[1:]):
            return cfg[0], None
        return None, tuple(cfg)
    return cfg, None


def _make_inner(op: BlockOperator, cfg):
    """``(rhs, x) -> KrylovResult`` over the stacked ``(nb, bs)`` blocks.
    A per-block sequence of configs solves each block on its own with its
    own config, as the JAX package unrolls them."""
    uniform, per_block = _per_block(cfg, op.nblocks, "InnerConfig")
    if per_block is None:
        return _make_single_inner(op, uniform)
    solves = [_make_single_inner(op, c, only_block=i)
              for i, c in enumerate(per_block)]

    def run(rhs, x):
        return _cat_results([solve(rhs[i:i + 1], x[i:i + 1])
                             for i, solve in enumerate(solves)])

    return run


def _cat_results(results) -> krylov.KrylovResult:
    """One ``KrylovResult`` over the systems of several batched ones, in
    order."""
    def cat(field):
        return torch.cat([getattr(r, field) for r in results])

    return krylov.KrylovResult(
        x=cat("x"), iters=cat("iters"), resnorm=cat("resnorm"),
        resnorm0=cat("resnorm0"), converged=cat("converged"),
        syncs=sum(r.syncs for r in results))


def _as_batch_of_one(r: krylov.KrylovResult) -> krylov.KrylovResult:
    """A single-system result as a batch of one system."""
    return krylov.KrylovResult(
        x=r.x[None], iters=r.iters.reshape(1), resnorm=r.resnorm.reshape(1),
        resnorm0=r.resnorm0.reshape(1), converged=r.converged.reshape(1),
        syncs=r.syncs)


def _block_args(args, i: int):
    """Block ``i``'s slice of ``diag_mv_args`` (a tensor, or a tuple of
    them, stacked on the block axis; None stays None)."""
    if args is None:
        return None
    if isinstance(args, (tuple, list)):
        return tuple(a[i] for a in args)
    return args[i]


def _bjacobi_inner_inv(op: BlockOperator, cfg: InnerConfig,
                       only_block: Optional[int] = None):
    """``(k, nbb, p, p)`` inverses of the ``p = pc_block_size`` diagonal
    sub-blocks of each ``A_ii`` for ``pc='bjacobi'`` (None for other pcs):
    every block's (``k = nblocks``), or with ``only_block`` that block's
    alone (``k = 1``).  The stacked sparse operators factor them on the
    host once per ``p`` and keep them (``diag_block_inverses``)."""
    if cfg.pc != "bjacobi":
        return None
    inverses = getattr(op, "diag_block_inverses", None)
    if inverses is None:
        raise ValueError(
            "pc='bjacobi' needs a sparse-family stacked operator "
            f"(ELL/DIA/BSR), got {type(op).__name__}; stencil strips "
            "use pc='mg'")
    inv = inverses(cfg.pc_block_size)
    return inv if only_block is None else inv[only_block:only_block + 1]


def _lanczos_block_bounds(op: BlockOperator, method: str):
    """The union over the blocks of each ``A_ii``'s Lanczos-estimated
    spectral interval (PETSc's ``-ksp_chebyshev_esteig``): a wider
    interval only slows Chebyshev, it never diverges it."""
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.eigest import (
        bounds_from_coeffs,
        lanczos_coeffs,
    )

    args = op.diag_mv_args
    if args is None:
        raise ValueError(
            f"{method} needs InnerConfig.eig_min/eig_max, analytic "
            f"diag_eig_bounds(), or per-block diag_mv_args for Lanczos "
            f"estimation")
    bs = op.block_size
    m = max(1, min(30, bs))
    v0 = np.random.default_rng(7).standard_normal(bs)
    leaf = args[0] if isinstance(args, (tuple, list)) else args
    v0 = torch.from_numpy(v0 / np.linalg.norm(v0)).to(device=leaf.device,
                                                     dtype=op.dtype)
    eps = float(torch.finfo(op.dtype).eps)
    per = []
    for i in range(op.nblocks):
        a = _block_args(args, i)
        alphas, betas = lanczos_coeffs(
            lambda u, a=a: op.single_diag_mv(a, u), v0, m)
        per.append(bounds_from_coeffs(alphas.cpu().numpy(),
                                      betas.cpu().numpy(), eps=eps))
    return min(p[0] for p in per), max(p[1] for p in per)


def _make_single_inner(op: BlockOperator, cfg: InnerConfig,
                       only_block: Optional[int] = None):
    """The batched solve ``(rhs, x) -> KrylovResult`` of one config over
    a stack of blocks, each block its own system with ``A_ii``: every
    block of ``op``, or with ``only_block`` that block alone (``rhs`` and
    ``x`` are then ``(1, bs)``)."""
    if cfg.method not in ("gmres", "cg", "bicgstab", "chebyshev", "ca_gmres"):
        raise ValueError(f"unknown inner method {cfg.method!r}")
    if cfg.pc not in ("none", "jacobi", "bjacobi", "mg"):
        raise ValueError(f"unknown inner pc {cfg.pc!r}")
    cfg.basis_dtype()   # rejects an unknown basis now, not mid-solve

    mg_M = None
    if cfg.pc == "mg":
        # multigrid on the strip's diagonal block: A_ii is a Dirichlet
        # Poisson operator on the strip
        diag_op_fn = getattr(op, "diag_stencil_op", None)
        if diag_op_fn is None:
            raise ValueError(f"pc='mg' needs a stencil-family block operator "
                             f"(got {type(op).__name__})")
        mg_M = _stacked_cycle(diag_op_fn())

    bounds = None
    if cfg.method in ("chebyshev", "ca_gmres"):
        # both need the spectral interval (the Chebyshev iteration, the
        # Newton basis's shifts)
        if cfg.pc != "none":
            raise ValueError(
                f"{cfg.method} inner solve does not compose with pc")
        if cfg.eig_min is not None and cfg.eig_max is not None:
            bounds = (cfg.eig_min, cfg.eig_max)
        elif hasattr(op, "diag_eig_bounds"):
            bounds = op.diag_eig_bounds()
        else:
            bounds = _lanczos_block_bounds(op, cfg.method)
    blocks = range(op.nblocks) if only_block is None else [only_block]
    binv = _bjacobi_inner_inv(op, cfg, only_block)
    bj_M = (None if binv is None
            else BlockJacobi(inv_blocks=binv, n=op.block_size).apply)
    dvec = None
    if cfg.pc == "jacobi":
        # each block's own diagonal (constant on the stencil strips)
        args = op.diag_mv_args
        dvec = torch.stack([
            op.single_diag_vector(_block_args(args, i), op.block_size)
            for i in blocks])
    precond = mg_M if mg_M is not None else bj_M

    def one_mv(row: int):
        """``A_ii`` of the block in row ``row`` of ``rhs``, on one vector."""
        a = _block_args(op.diag_mv_args, blocks[row])
        return lambda v: op.single_diag_mv(a, v)

    block_mv = op.diag_mv if only_block is None else one_mv(0)

    def solve(rhs, x):
        mv = block_mv
        if cfg.pc == "jacobi":
            # left diagonal preconditioning: (D^-1 A) x = D^-1 b, tested in
            # the preconditioned norm (PETSc's default)
            dinv = 1.0 / dvec.to(rhs)
            mv = lambda v: dinv * block_mv(v)   # noqa: E731
            rhs = dinv * rhs
        elif precond is not None and cfg.method == "gmres":
            # left multigrid or block-Jacobi preconditioning (convergence
            # in the preconditioned norm); CG and BiCGStab take it as a
            # true-residual preconditioner instead
            mv = lambda v: precond(block_mv(v))    # noqa: E731
            rhs = precond(rhs)
        if cfg.method == "chebyshev":
            return chebyshev(mv, rhs, x, lmin=bounds[0], lmax=bounds[1],
                             maxiter=cfg.maxiter, batched=True)
        if cfg.method == "cg":
            return krylov.cg(mv, rhs, x, maxiter=cfg.maxiter, rtol=cfg.rtol,
                             atol=cfg.atol, precond=precond, batched=True)
        if cfg.method == "bicgstab":
            # mg or bjacobi enters as a right preconditioner (true-residual
            # test); jacobi is already folded into mv and rhs
            return krylov.bicgstab(mv, rhs, x, maxiter=cfg.maxiter,
                                   rtol=cfg.rtol, atol=cfg.atol,
                                   precond=precond, batched=True)
        if cfg.method == "ca_gmres":
            # s-step GMRES over the block spectrum, one Gram matrix per
            # cfg.restart matvecs; one solve per block (ca_gmres takes one
            # system)
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.castep import (  # noqa: E501
                ca_gmres,
            )

            return _cat_results([
                _as_batch_of_one(ca_gmres(
                    one_mv(i), rhs[i], x[i], s=cfg.restart,
                    maxiter=cfg.maxiter, rtol=cfg.rtol, atol=cfg.atol,
                    lmin=bounds[0], lmax=bounds[1], reductions="single"))
                for i in range(rhs.shape[0])])
        return krylov.gmres(mv, rhs, x, restart=cfg.restart,
                            maxiter=cfg.maxiter, rtol=cfg.rtol,
                            atol=cfg.atol, orthog=cfg.orthog,
                            basis_dtype=cfg.basis_dtype())

    return solve


def _stacked_cycle(diag_op):
    """``M(r)`` for a stack ``r`` of ``(k, bs)`` strip residuals: one
    multigrid cycle on each strip's ``A_ii``.  The 2D cycle takes the
    stack as a batch of grids; the 3D kernels take one grid, so a 3D
    stack runs one cycle per strip."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
        Stencil3D,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
        mg_preconditioner,
    )

    M = mg_preconditioner(diag_op)
    if not isinstance(diag_op, Stencil3D):
        return M
    return lambda r: torch.stack([M(ri) for ri in r]) if r.dim() > 1 else M(r)


# ---------------------------------------------------------------------------
# Tall-skinny least squares
# ---------------------------------------------------------------------------

def _solve_ls(R: torch.Tensor, rhs: torch.Tensor, cfg: OuterConfig):
    """``(argmin_a ||rhs - R a||, host reads)`` for a panel ``R`` of shape
    ``(rows, s)``, or a batch ``(batch, rows, s)`` of them."""
    if cfg.method == "qr":
        return lstsq_qr(R, rhs), 0
    if cfg.method == "normal":
        return lstsq_normal(R, rhs, l2=cfg.damping), 0
    if cfg.method not in ("lsqr", "cgne"):
        raise ValueError(f"unknown outer method {cfg.method!r}")
    if R.dim() == 3:
        # one solve per block: what vmap of the JAX while_loop computes
        out = [_solve_ls(Rb, tb, cfg) for Rb, tb in zip(R, rhs)]
        return torch.stack([a for a, _ in out]), sum(k for _, k in out)
    mv = lambda a: full_matmul(R, a)                    # noqa: E731
    rmv = lambda u: full_matmul(R.transpose(0, 1), u)   # noqa: E731
    if cfg.method == "lsqr":
        res = lsqr(mv, rmv, rhs, n=R.shape[1], maxiter=cfg.maxiter,
                   rtol=cfg.rtol, atol=cfg.atol)
    else:
        res = cgne(mv, rmv, rhs, maxiter=cfg.maxiter, rtol=cfg.rtol,
                   atol=cfg.atol)
    return res.x, res.syncs


# ---------------------------------------------------------------------------
# Main driver
# ---------------------------------------------------------------------------

def multisplit_solve(
    op: BlockOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
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
    rnorm0=None,
    basis_collection: str = "sweep",
) -> MultisplitResult:
    """Solve ``A x = b`` by (a)synchronous two-stage block multisplitting;
    ``b`` and the returned ``x`` are stacked ``(nblocks, block_size)``.

    The parameters are the JAX ``multisplit_solve``'s: the reference's
    CLI surface (``-s -rtol -min_convergence_count`` and the prefixed
    inner/outer KSP options).  ``inner`` and ``outer`` may be per-block
    sequences (outer ones only for the 'local'/'semi_local' scopes).
    ``rnorm0`` pins the test's reference norm (default ``||b - A x0||``).
    ``basis_collection`` (async minimization only): 'sweep' records a
    basis column every sweep; 'publish' only when a block publishes, one
    cycle then spanning ``s * max(staleness)`` sweeps.
    """
    if schedule not in ("sync", "async"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    if basis_collection not in ("sweep", "publish"):
        raise ValueError(f"unknown basis_collection {basis_collection!r}")
    is_async = schedule == "async"
    nb, bs = op.nblocks, op.block_size
    dtype, dev = b.dtype, b.device
    if tuple(b.shape) != (nb, bs):
        raise ValueError(f"b must be ({nb}, {bs}), got {tuple(b.shape)}")
    if minimization is None:
        s = 1   # one sweep per convergence check, as in SM/AM
    stal = ([int(staleness)] * nb if isinstance(staleness, int)
            else [int(v) for v in staleness])
    if len(stal) != nb:
        raise ValueError(f"staleness needs {nb} entries, got {len(stal)}")
    if not is_async and any(v != 1 for v in stal):
        raise ValueError("sync schedule requires staleness == 1")

    inner_solve = _make_inner(op, inner)
    outer_u, outer_pb = _per_block(outer, nb, "OuterConfig")
    if outer_pb is not None:
        if minimization == "global":
            raise ValueError(
                "per-block OuterConfig applies to 'local'/'semi_local' "
                "scopes (the global minimization is one shared LS solve)")
        if len({c.alpha_average for c in outer_pb}) != 1:
            raise ValueError(
                "alpha_average must agree across per-block OuterConfigs")
    outer = outer_u if outer_pb is None else outer_pb[0]

    if x0 is None:
        x0 = torch.zeros((nb, bs), dtype=dtype, device=dev)
    if rnorm0 is None:
        # the reference's UIRNorm: the initial residual at entry
        r0 = b - op.full_mv(x0)
        rnorm0 = torch.sqrt(torch.sum(r0 * r0))
    else:
        rnorm0 = torch.as_tensor(rnorm0, dtype=dtype, device=dev)
    tol_global = torch.clamp_min(rtol * rnorm0, atol)
    # per-block threshold rtol/sqrt(nb) ||r0|| (the reference's
    # rtol/sqrt(2), `...-local.c:267`, for nb blocks)
    sqrt_nb = torch.sqrt(torch.tensor(float(nb), dtype=dtype, device=dev))
    tol_local = torch.clamp_min(rtol / sqrt_nb * rnorm0, atol)

    collect_publish = (basis_collection == "publish" and is_async
                       and minimization is not None)
    spc = s * max(stal) if collect_publish else s   # sweeps per cycle
    syncs = 0

    def publish(x, x_vis, sweep_count):
        """Each block's visible iterate: its new one on its publish
        sweeps, else the one it published last."""
        done = [sweep_count % v == 0 for v in stal]
        if all(done):
            return x
        if not any(done):
            return x_vis
        return torch.stack([x[i] if d else x_vis[i]
                            for i, d in enumerate(done)])

    def minimize(S, x_vis, rhs, sweeps):
        """One outer minimization: basis ``S (s, nb, bs)`` -> combined x.
        'local' takes ``R = A_ii S_i`` against the frozen ``rhs``,
        'semi_local'/'global' the full row strips ``A_i S`` against ``b``
        (reference ``...-local.c:256``, ``...-semi-local.c:319``,
        ``...-global.c:325``)."""
        if minimization == "local":
            Rcols, target = op.diag_mv(S), rhs
        else:
            Rcols, target = op.full_mv(S), b
        if minimization == "global":
            n = nb * bs
            R = Rcols.reshape(s, n)
            alpha, reads = _solve_ls(R.transpose(0, 1), target.reshape(-1),
                                     outer)
            alpha = alpha[None].contiguous()
            out_r = maxpy(R[None], -alpha, target.reshape(1, n), s)
            x_new = maxpy(S.reshape(1, s, n), alpha,
                          torch.zeros((1, n), dtype=dtype, device=dev), s)
            x_new = x_new.reshape(nb, bs)
        else:
            Rb = Rcols.permute(1, 2, 0)                 # (nb, bs, s)
            if outer_pb is not None:
                out = [_solve_ls(Rb[i], target[i], outer_pb[i])
                       for i in range(nb)]
                alpha = torch.stack([a for a, _ in out])
                reads = sum(k for _, k in out)
            else:
                alpha, reads = _solve_ls(Rb, target, outer)
            if outer.alpha_average:
                alpha = alpha.mean(dim=0, keepdim=True).expand(nb, s)
            alpha = alpha.contiguous()
            out_r = maxpy(Rcols.permute(1, 0, 2), -alpha, target, s)
            x_new = maxpy(S.permute(1, 0, 2), alpha, torch.zeros_like(b), s)
        outer_rnorm = torch.sqrt(torch.sum(out_r * out_r))
        x_vis = publish(x_new, x_vis, sweeps)
        return x_new, x_vis, b - op.coupling_mv(x_vis), outer_rnorm, reads

    x, x_vis = x0, x0
    rhs = b - op.coupling_mv(x_vis)
    sweeps = cycles = 0
    inner_total = torch.zeros((), dtype=torch.int64, device=dev)
    conv_count = torch.zeros(nb, dtype=torch.int64, device=dev)
    rnorm = rnorm0
    local_rnorms = torch.full((nb,), float("inf"), dtype=dtype, device=dev)
    outer_rnorm = torch.tensor(float("inf"), dtype=dtype, device=dev)
    max_cycles = -(-maxiter // s) if record_history else 1
    hist = torch.full((max_cycles,), float("inf"), dtype=dtype, device=dev)
    syncs += 1
    converged = bool(rnorm0 <= tol_global)
    while not converged and sweeps < maxiter:
        if minimization is not None:
            S = (torch.zeros if collect_publish else torch.empty)(
                (s, nb, bs), dtype=dtype, device=dev)
        pub = [False] * nb
        pub_counts = [0] * nb
        for i in range(spc):
            res = inner_solve(rhs, x)
            syncs += res.syncs
            x = res.x
            inner_total = inner_total + res.iters.sum()
            sweeps += 1
            published = [sweeps % v == 0 for v in stal]
            pub = [p or q for p, q in zip(pub, published)]
            x_vis = publish(x, x_vis, sweeps)
            rhs = b - op.coupling_mv(x_vis)
            if minimization is None:
                continue
            if collect_publish:
                # a column only when its block publishes, so every column
                # holds fresh peer data; slots cycle, keeping the newest s
                for blk in range(nb):
                    if published[blk]:
                        S[pub_counts[blk] % s, blk] = x[blk]
                        pub_counts[blk] += 1
            else:
                S[i] = x
        if minimization is not None:
            x, x_vis, rhs, outer_rnorm, reads = minimize(S, x_vis, rhs,
                                                         sweeps)
            syncs += reads

        # local residual rows r_i = rhs - A_ii x_i: with a sync exchange
        # the true global residual rows (the reference's MatResidual test)
        local_r = rhs - op.diag_mv(x)
        local_sq = torch.sum(local_r * local_r, dim=1)
        local_rnorms = torch.sqrt(local_sq)
        rnorm = torch.sqrt(torch.sum(local_sq))
        if record_history:
            hist[cycles] = rnorm
        cycles += 1

        if is_async:
            # pseudo-period gate (Alg-5.15): an under-threshold cycle
            # counts toward termination only when every block published
            # fresh data during it
            under = local_rnorms <= tol_local
            kept = conv_count + 1 if all(pub) else conv_count
            conv_count = torch.where(under, kept, 0)
            done = torch.all(conv_count >= min_convergence_count)
        elif minimization == "global":
            done = outer_rnorm <= tol_global
        elif minimization is not None:
            done = torch.all(local_rnorms <= tol_local)
        else:
            done = rnorm <= tol_global
        syncs += 1
        converged = bool(done)

    certified = tail_sweeps = None
    if is_async:
        # lockstep certification: async cycles measure residuals against
        # the staleness view x_vis; sync sweeps on the true coupling until
        # every block's true residual is under its threshold (at most 64)
        def true_resid(x_c):
            local_r = b - op.coupling_mv(x_c) - op.diag_mv(x_c)
            lsq = torch.sum(local_r * local_r, dim=1)
            return (torch.all(torch.sqrt(lsq) <= tol_local), torch.sqrt(lsq),
                    torch.sqrt(torch.sum(lsq)))

        ok_t, lr_t, rn_t = true_resid(x)
        tail_sweeps = 0
        ok = True
        if converged:   # only protocol-converged runs are certified
            syncs += 1
            ok = bool(ok_t)
            while not ok and tail_sweeps < 64:
                res = inner_solve(b - op.coupling_mv(x), x)
                syncs += res.syncs + 1
                x = res.x
                ok_t, lr_t, rn_t = true_resid(x)
                tail_sweeps += 1
                ok = bool(ok_t)
            rnorm, local_rnorms = rn_t, lr_t
        certified = converged and ok
        sweeps += tail_sweeps
        converged = certified

    return MultisplitResult(
        x=x, sweeps=sweeps, cycles=cycles, inner_iters=inner_total,
        rnorm=rnorm, rnorm0=rnorm0, local_rnorms=local_rnorms,
        outer_rnorm=outer_rnorm, converged=converged,
        history=hist if record_history else None, certified=certified,
        tail_sweeps=tail_sweeps, syncs=syncs)


# ---------------------------------------------------------------------------
# Named entry points (one per reference binary)
# ---------------------------------------------------------------------------

def sm(op, b, **kw):
    """Synchronous multisplitting (reference SM)."""
    return multisplit_solve(op, b, schedule="sync", minimization=None, **kw)


def am(op, b, *, staleness=2, **kw):
    """Asynchronous multisplitting under bounded staleness (reference AM)."""
    return multisplit_solve(op, b, schedule="async", staleness=staleness,
                            minimization=None, **kw)


def smsm(op, b, *, scope: str = "global", s: int = 4, **kw):
    """Synchronous multisplitting + synchronous minimization (reference
    SMSM_{LOCAL,SEMI_LOCAL,GLOBAL})."""
    return multisplit_solve(op, b, schedule="sync", minimization=_scope(scope),
                            s=s, **kw)


def amam(op, b, *, scope: str = "global", s: int = 4, staleness=2, **kw):
    """Asynchronous multisplitting + asynchronous minimization (reference
    AMAM_{LOCAL,SEMI_LOCAL,GLOBAL})."""
    return multisplit_solve(op, b, schedule="async", staleness=staleness,
                            minimization=_scope(scope), s=s, **kw)


def _scope(scope: str) -> str:
    aliases = {"local": "local", "semi_local": "semi_local",
               "semi-local": "semi_local", "semilocal": "semi_local",
               "global": "global"}
    if scope not in aliases:
        raise ValueError(f"unknown minimization scope {scope!r}")
    return aliases[scope]
