"""The SPMD multisplitting engine shared by the sharded layouts (port of
the JAX package's ``parallel/engine.py``).

The outer loop (sweeps, staleness publishing, s-step basis collection,
the minimization, the pseudo-period-gated termination) is the same for
every layout; only the local applies, the local tile shape and the mesh
axes differ.  ``make_spmd_body`` builds it once; the layouts
(``sharded``, ``tiled``) supply:

* ``diag_mv(g)``: A_ii on the local tiles (intra-block halos inside);
* ``coupling_mv(g)``: A_ij from the published peer-block state;
* ``inner_solve(rhs, x)``: the per-block Krylov solve, lockstep across
  blocks (fixed cycle counts);
* ``lshape``: the local tile shape;
* ``intra_axes``/``all_axes``: the mesh axes of block-local and global
  reductions ('block' leads ``all_axes``).

Sharded tensors carry the mesh's local dims first: ``(nb, ni, *lshape)``
for the iterate, ``(nb, ni, s, *lshape)`` for the basis.  JAX runs the
loop as a ``lax.while_loop`` in one program; here it runs on the host.
Every choice that depends on counts only (sweeps, publish schedules,
basis slots) is made there with no device read; the loop test is read
once per outer cycle, and it is the same on every process (a global
reduction).  The s-step panel's combinations (``S alpha`` and the
residual ``tgt - R alpha``) are kernel G (``ops.fused.maxpy``) over the
shard stack.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.fused import maxpy
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
)


def make_spmd_body(
    *,
    mesh,
    diag_mv: Callable,
    coupling_mv: Callable,
    inner_solve: Callable,
    lshape: Tuple[int, ...],
    nb: int,
    intra_axes: Sequence[str],
    all_axes: Sequence[str],
    is_async: bool,
    stal: Sequence[int],        # publish period of each block
    minimization: Optional[str],
    s: int,
    outer,                      # OuterConfig
    rtol: float,
    atol: float,
    maxiter: int,
    min_convergence_count: int,
    dtype: torch.dtype,
    record_history: bool = False,
    basis_collection: str = "sweep",
    pinned_rnorm0=None,
) -> Callable:
    """``body(b, x0) -> (x, sweeps, cycles, inner_total, rnorm, rnorm0,
    block_norm, outer_rnorm, converged, history)`` over shard stacks
    ``b``, ``x0`` of shape ``(*mesh.local_shape, *lshape)``.  ``rnorm``,
    ``rnorm0``, ``outer_rnorm`` and ``inner_total`` are 0-d tensors,
    ``block_norm`` is per shard, the counts and the flag host values."""
    if basis_collection not in ("sweep", "publish"):
        raise ValueError(f"unknown basis_collection {basis_collection!r}")
    intra_axes, all_axes = tuple(intra_axes), tuple(all_axes)
    lsize = math.prod(lshape)
    mdims = mesh.ndim
    nsh = mesh.nlocal
    collect_publish = (basis_collection == "publish" and is_async
                       and minimization is not None)
    spc = s * max(stal) if collect_publish else s
    max_cycles = -(-maxiter // max(s, 1)) if record_history else 1
    nb_loc = mesh.local_shape[0]
    blk0 = mesh.proc_coords[0] * nb_loc      # this process's first block
    my_stal = [stal[blk0 + k] for k in range(nb_loc)]
    lead = (slice(None),) * mdims       # the basis slot follows the mesh dims
    rest = (slice(None),) * (mdims - 1)

    first = mesh.local

    def sq_norms(v: torch.Tensor) -> torch.Tensor:
        """Each shard's sum of squares over its tile."""
        return torch.sum(v * v, dim=tuple(range(mdims, v.dim())))

    def publish(x, x_vis, sweeps):
        done = [sweeps % v == 0 for v in my_stal]
        if all(done):
            return x
        if not any(done):
            return x_vis
        return torch.stack([x[k] if d else x_vis[k]
                            for k, d in enumerate(done)])

    def solve_gram(G, c):
        eye = torch.eye(s, dtype=dtype, device=G.device)
        jitter = (torch.finfo(dtype).eps
                  * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / s
                  + outer.damping)
        ch, info = torch.linalg.cholesky_ex(G + jitter[:, None, None] * eye)
        # a Gram that is not positive definite gives NaN, as JAX's
        # cho_factor does (no exception, no host read)
        ch = torch.where((info != 0)[:, None, None], torch.nan, ch)
        return torch.cholesky_solve(c[:, :, None], ch)[:, :, 0]

    def alpha_normal(Rmat, tgt, axes):
        """Gram normal equations (reference ``outer_solver_cholesky``,
        ``utils.c:972-996``): one s x s psum."""
        red = mesh.reducer(axes)
        Rt = Rmat.transpose(1, 2)
        G = red(full_matmul(Rt, Rmat))
        c = red(full_matmul(Rt, tgt[:, :, None])[:, :, 0])
        return solve_gram(G, c)

    def alpha_tsqr(Rmat, tgt, axes):
        """Two-level tall-skinny QR (reference ``outer_solver_qr``,
        ``utils.c:998-1020``): a local reduced QR of each shard's panel,
        the target projected through it, then an all_gather of the small
        R factors and projected targets and one replicated QR of their
        stack."""
        Q0, R0 = torch.linalg.qr(Rmat, mode="reduced")
        t0 = full_matmul(Q0.transpose(1, 2), tgt[:, :, None])[:, :, 0]

        def gather(t):
            g = mesh.all_gather(t.reshape(mesh.local_shape + t.shape[1:]),
                                axes)
            return g.reshape((nsh, -1) + t.shape[2:])

        Rs = gather(R0).reshape(nsh, -1, s)       # (nsh, P*s, s)
        ts = gather(t0).reshape(nsh, -1)          # (nsh, P*s)
        Q1, R1 = torch.linalg.qr(Rs, mode="reduced")
        t1 = full_matmul(Q1.transpose(1, 2), ts[:, :, None])
        return torch.linalg.solve_triangular(R1, t1, upper=True)[:, :, 0]

    def alpha_lsqr(Rmat, tgt, axes):
        """Iterative LSQR on the row-sharded panel (reference
        ``outer_solver_lsqr``): the matvec is local, the rmatvec reduces;
        instances of a 'local'/'semi_local' scope run lockstep over
        'block'."""
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lsqr import (
            lsqr,
        )

        red = mesh.reducer(axes)
        Rt = Rmat.transpose(1, 2)
        res = lsqr(
            lambda a: full_matmul(Rmat, a[:, :, None])[:, :, 0],
            lambda u: red(full_matmul(Rt, u[:, :, None])[:, :, 0]),
            tgt, n=s, maxiter=outer.maxiter, rtol=outer.rtol,
            atol=outer.atol, axis_name=axes,
            lockstep_axis=None if "block" in axes else "block", mesh=mesh)
        return res.x

    solve_alpha = {"normal": alpha_normal, "qr": alpha_tsqr,
                   "lsqr": alpha_lsqr}[outer.method]

    def minimize(S, rhs, b_loc):
        """One outer minimization over the basis ``S`` (mesh dims, s,
        *lshape) -> ``(x_new, outer_rnorm)``."""
        if minimization == "local":
            Rcols, target, axes = diag_mv(S), rhs, intra_axes
        else:
            Rcols = diag_mv(S) + coupling_mv(S)
            target = b_loc
            axes = intra_axes if minimization == "semi_local" else all_axes
        R = Rcols.reshape(nsh, s, lsize)
        tgt = target.reshape(nsh, lsize)
        alpha = solve_alpha(R.transpose(1, 2), tgt, axes)
        if outer.alpha_average and minimization != "global":
            # the reference's *_modify alpha exchange (comm.c:143-197):
            # alpha is replicated over the intra axes, so a pmean over
            # 'block' is the whole exchange
            alpha = mesh.pmean(alpha.reshape(mesh.local_shape + (s,)),
                               "block").reshape(nsh, s)
        alpha = alpha.contiguous()
        resid = maxpy(R, -alpha, tgt, s)
        out_sq = mesh.psum(torch.sum(resid * resid, dim=-1).reshape(
            mesh.local_shape), axes)
        x_new = maxpy(S.reshape(nsh, s, lsize), alpha,
                      torch.zeros_like(tgt), s)
        return x_new.reshape(target.shape), torch.sqrt(first(out_sq))

    def block_norms(rhs, x):
        local_r = rhs - diag_mv(x)
        return torch.sqrt(mesh.psum(sq_norms(local_r), intra_axes))

    def body(b_loc: torch.Tensor, x0: torch.Tensor):
        r0 = b_loc - diag_mv(x0) - coupling_mv(x0)
        r0norm = torch.sqrt(first(mesh.psum(sq_norms(r0), all_axes)))
        rnorm0 = (r0norm if pinned_rnorm0 is None else torch.as_tensor(
            pinned_rnorm0, dtype=dtype, device=b_loc.device))
        tol_global = torch.clamp_min(rtol * rnorm0, atol)
        tol_local = torch.clamp_min(
            rtol / torch.sqrt(torch.tensor(float(nb), dtype=dtype,
                                           device=b_loc.device)) * rnorm0,
            atol)

        x = x_vis = x0
        rhs = b_loc - coupling_mv(x0)
        sweeps = cycles = 0
        inner_total = torch.zeros((), dtype=torch.int32, device=b_loc.device)
        conv_count = torch.zeros(mesh.local_shape, dtype=torch.int32,
                                 device=b_loc.device)
        rnorm = r0norm
        outer_rnorm = torch.tensor(float("inf"), dtype=dtype,
                                   device=b_loc.device)
        hist = torch.full((max_cycles,), float("inf"), dtype=dtype,
                          device=b_loc.device)
        converged = bool(r0norm <= tol_global)
        while not converged and sweeps < maxiter:
            S = torch.zeros(mesh.local_shape + (s,) + tuple(lshape),
                            dtype=dtype, device=b_loc.device)
            pc = [0] * nb_loc
            swept = []
            for i in range(spc):
                res = inner_solve(rhs, x)
                x = res.x.reshape(x.shape)
                iters = res.iters.reshape(mesh.local_shape).to(torch.int32)
                inner_total = inner_total + first(mesh.psum(iters, "block"))
                sweeps += 1
                swept.append(sweeps)
                x_vis = publish(x, x_vis, sweeps)
                rhs = b_loc - coupling_mv(x_vis)
                if collect_publish:
                    # a column only when its block publishes; slots cycle
                    for k, v in enumerate(my_stal):
                        if sweeps % v == 0:
                            S[(k,) + rest + (pc[k] % s,)] = x[k]
                            pc[k] += 1
                elif minimization is not None:
                    S[lead + (i,)] = x
            if minimization is not None:
                x, outer_rnorm = minimize(S, rhs, b_loc)
                x_vis = publish(x, x_vis, sweeps)
                rhs = b_loc - coupling_mv(x_vis)

            block_norm = block_norms(rhs, x)
            rnorm = torch.sqrt(first(mesh.psum(torch.square(block_norm),
                                               "block")))
            if record_history:
                hist[cycles] = rnorm
            cycles += 1

            if is_async:
                # pseudo-period gate: only publish-complete cycles count
                all_pub = all(any(w % v == 0 for w in swept) for v in stal)
                under = block_norm <= tol_local
                conv_count = torch.where(
                    ~under, 0, conv_count + 1 if all_pub else conv_count)
                ok = (conv_count >= min_convergence_count).to(torch.int32)
                done = first(mesh.psum(ok, "block")) == nb
            elif minimization == "global":
                done = outer_rnorm <= tol_global
            elif minimization is not None:
                ok = (block_norm <= tol_local).to(torch.int32)
                done = first(mesh.psum(ok, "block")) == nb
            else:
                done = rnorm <= tol_global
            converged = bool(done)

        block_norm = block_norms(rhs, x)
        return (x, sweeps, cycles, inner_total, rnorm, rnorm0, block_norm,
                outer_rnorm, converged, hist)

    return body
