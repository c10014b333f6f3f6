"""Host-driven, genuinely asynchronous multisplitting (AM / AMAM_*) (port
of the JAX package's ``models/host_async.py``).

``models.multisplitting`` emulates asynchrony with a bounded-staleness
schedule.  This backend runs the reference's own execution model
(``asynchronous-multisplitting_prime.c``): each Jacobi block advances at
its own pace on its own host thread, exchanges iterates through
drain-to-newest mailboxes (the analog of ``comm_async_probe_and_
receive``'s Iprobe/drain loop, ``comm.c:6-55``) and detects termination
with the decentralized Alg-5.15 protocol (``models.convergence``).  The
interleavings are nondeterministic; the theory of totally asynchronous
iterations (a contracting block Jacobi operator) gives convergence.

Each block thread runs its sweeps as plain tensor code on its block's
device, inside a CUDA stream of its own, so one block's kernels and
PyTorch operations are ordered among themselves and overlap with the
other block's on the card.  The operator and ``b`` are made before the
threads start and only read by them; iterates cross threads only as host
numpy copies.  One Python interpreter drives both threads, so an eager
sweep of a few thousand launches shares the GIL with its peer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
    BlockOperator,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.convergence import (
    Alg515Node,
    LocalTransport,
    State,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
    OuterConfig,
    _block_args,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
    lstsq_qr,
)


@dataclasses.dataclass
class HostAsyncResult:
    x: torch.Tensor            # (nblocks, block_size)
    sweeps_per_block: List[int]
    rnorm: float
    rnorm0: float
    converged: bool
    elapsed_s: float
    # lockstep-tail certificate (see _sync_certify): True means the
    # returned x satisfies ||b - A x|| <= rtol*||b|| exactly
    certified: bool = False
    tail_rounds: int = 0


def _block_mv(op, k: int):
    """``v -> A_kk v`` for block ``k`` (``v`` one vector or a stack)."""
    a_k = _block_args(getattr(op, "diag_mv_args", None), k)
    return lambda v: op.single_diag_mv(a_k, v)


def _gmres_sweep(mv, inner: InnerConfig):
    """``(rhs_b, x_b) -> (x_b', ||rhs_b - A_kk x_b||)``: one inner GMRES
    solve of a block, with the residual of the CURRENT iterate against
    the FRESH right-hand side, measured before the solve.  That is the
    block's rows of the true global residual given the latest peer data,
    and it is what the under-threshold test must use: measured after the
    solve against the same rhs it would always look converged once the
    inner solver reaches its tolerance, whatever the global error."""
    def sweep(rhs_b, x_b):
        r_pre = rhs_b - mv(x_b)
        pre_norm = torch.sqrt(torch.sum(r_pre * r_pre))
        res = krylov.gmres(mv, rhs_b, x_b, restart=inner.restart,
                           maxiter=inner.maxiter, rtol=inner.rtol,
                           atol=inner.atol, orthog=inner.orthog)
        return res.x, pre_norm

    return sweep


def _intra_config(op, intra: int, minimization):
    """The sharded stencil of one block for ``intra > 1``, with JAX's
    errors."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
        StackedStencil2D,
        StackedStencil3D,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.sharded import (
        ShardedPoisson2D,
        ShardedPoisson3D,
    )

    if minimization is not None:
        raise ValueError("intra>1 host_async runs AM (no minimization yet)")
    if isinstance(op, StackedStencil2D):
        opcfg = ShardedPoisson2D(op.rows, op.n, op.diag, op.off)
    elif isinstance(op, StackedStencil3D):
        opcfg = ShardedPoisson3D(op.rows, op.ny, op.nz, op.diag, op.off)
    else:
        raise ValueError("intra>1 host_async needs a stencil block operator")
    if opcfg.split_extent % intra:
        raise ValueError(f"block rows {opcfg.split_extent} not divisible by "
                         f"intra={intra}")
    return opcfg


def _sharded_sweep(opcfg, intra: int, inner: InnerConfig, device):
    """``_gmres_sweep`` of one block over its own ``('intra',)`` sub-mesh
    of ``intra`` shards on the ``'local'`` transport: the block's rows
    split into ``intra`` strips, boundary rows exchanged by ``ppermute``,
    the dots reduced by ``psum`` over 'intra'."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.mesh import (
        Mesh,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.sharded import (
        _add_rows,
        strip_halos,
    )

    sub = Mesh(("intra",), (intra,), device=device)
    halos, _ = strip_halos(sub)
    spec = ("intra",)
    shape = (opcfg.split_extent, opcfg.fdim)

    def diag_mv(g):
        top, bot = halos(g)
        return _add_rows(opcfg.interior_mv(g), opcfg.off, top, bot)

    def sweep(rhs_b, x_b):
        rhs = sub.shard(rhs_b.reshape(shape), spec)
        x = sub.shard(x_b.reshape(shape), spec)
        r_pre = rhs - diag_mv(x)
        pre = torch.sqrt(sub.local(sub.psum(
            torch.sum(r_pre * r_pre, dim=(1, 2)), "intra")))
        res = krylov.gmres(
            lambda v: diag_mv(v.reshape(rhs.shape)).reshape(intra, -1),
            rhs.reshape(intra, -1), x.reshape(intra, -1),
            restart=inner.restart, maxiter=inner.maxiter, rtol=inner.rtol,
            atol=inner.atol, orthog=inner.orthog, axis_name="intra",
            mesh=sub)
        return sub.unshard(res.x.reshape(rhs.shape), spec, shape).reshape(
            -1), pre

    return sweep


def _minimize_local(mv, S_cols, rhs_b):
    """The block's own s-column basis minimized against ``rhs_b``: ``R =
    A_kk S`` per column, a direct tall-skinny least squares (the analog
    of ``outer_solver_lsqr`` on the local basis)."""
    R = mv(S_cols).transpose(0, 1)            # (bs, s)
    alpha = lstsq_qr(R, rhs_b)
    return full_matmul(S_cols.transpose(0, 1), alpha)


def _gram(R, target):
    """``(R Rᵀ, R target)`` for a panel ``R (s, n)``, both products in f64
    whatever ``R``'s dtype.  The s columns are successive iterates, nearly
    collinear, so ``R Rᵀ`` is conditioned like ``cond(R)²`` (1e6-1e8
    measured); an f32 product of 2048-long rows (PyTorch's CPU matmul)
    lost its small directions, and the async minimizations then took 3x
    the sweeps (global) or diverged (semi_local) at 64² in f32, where JAX's
    f32 dot did not."""
    R64 = R.double()
    return R64 @ R64.transpose(0, 1), R64 @ target.double()


def _gram_contrib(op, b, k: int, S_full):
    """``S_full (s, nb, bs)`` full-length snapshots: block ``k``'s rows of
    ``R = A S`` and their Gram panel ``(R Rᵀ, R b_k)`` in f64 (the s x s
    exchange that replaces the reference's dense-R shipping,
    ``comm_async_*_min``, ``comm.c:288-351``)."""
    return _gram(op.full_mv(S_full)[:, k, :], b[k])      # rows (s, bs)


def _combine(S_own, alpha):
    return full_matmul(S_own.transpose(0, 1), alpha)


def _solve_gram_np(G, c):
    """Minimum-norm least squares of the Gram system on the host in f64:
    early bases can be rank-deficient (near-parallel iterates, zero peer
    parts at the start)."""
    return np.linalg.lstsq(np.asarray(G, np.float64),
                           np.asarray(c, np.float64), rcond=None)[0]


def _init_linalg(dev: torch.device, dtype: torch.dtype) -> None:
    """Run the dense linear algebra of a block's sweep (GMRES's triangular
    solve, the minimization's QR) once on ``dev`` in the calling thread:
    PyTorch loads those libraries lazily at the first call, and the first
    calls of two threads race ("lazy wrapper should be called at most
    once")."""
    a = torch.eye(2, dtype=dtype, device=dev)
    torch.linalg.solve_triangular(a, a, upper=True)
    torch.linalg.qr(a)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch float dtype (the host copies and the
    wire frames)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def _sync_certify(op, b, x, tol_local, inner, *, max_rounds=50):
    """Post-verdict lockstep certification (the in-process analog of
    ``net_async._certification_tail``).

    Alg-5.15 certifies each block against stale-but-fresh peer data, so
    the MERGED residual of the protocol-terminated stack can exceed
    rtol·‖b‖ by ~(1+‖A_ic‖·‖A_ii⁻¹‖).  Here all threads have joined, so
    certification is direct: measure every block's rows of the true
    global residual on the identical stack; while any block is over
    ``tol_local``, run one synchronous Jacobi round (the sync handshake
    ``comm_sync_convergence_detection``, ``comm.c:235-250``, collapsed to
    in-process lockstep).  Returns ``(x, certified, rounds)``; all blocks
    under ``tol_local = rtol*||b||/sqrt(nb)`` on the same x certifies the
    merged bound exactly."""
    nb = op.nblocks
    mvs = [_block_mv(op, k) for k in range(nb)]

    def jacobi_round(x_stack):
        rhs = b - op.coupling_mv(x_stack)
        return torch.stack([
            krylov.gmres(mvs[k], rhs[k], x_stack[k], restart=inner.restart,
                         maxiter=inner.maxiter, rtol=inner.rtol,
                         atol=inner.atol, orthog=inner.orthog).x
            for k in range(nb)])

    for rounds in range(max_rounds + 1):
        r = b - op.full_mv(x)
        pb = torch.sqrt(torch.sum(r * r, dim=1)).cpu().numpy()
        if bool(np.all(pb <= tol_local)):
            return x, True, rounds
        if rounds == max_rounds:
            break
        x = jacobi_round(x)
    return x, False, max_rounds


class _Mailbox:
    """Latest-value-wins slot: publish overwrites, read drains the newest
    (exactly the reference's drain-to-newest receive semantics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None
        self._version = 0

    def publish(self, value) -> None:
        with self._lock:
            self._value = value
            self._version += 1

    def read(self):
        with self._lock:
            return self._value, self._version


def host_async_solve(
    op: BlockOperator,
    b: torch.Tensor,
    *,
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    inner: InnerConfig = InnerConfig(),
    minimization: Optional[str] = None,   # None | 'local' | 'semi_local' | 'global'
    s: int = 4,
    outer: OuterConfig = OuterConfig(),
    devices: Optional[list] = None,
    sweep_delay_s: Optional[List[float]] = None,
    join_timeout_s: float = 600.0,
    intra: int = 1,
) -> HostAsyncResult:
    """Solve ``A x = b`` with one independent host thread per block;
    ``b`` is stacked ``(nblocks, block_size)``.

    ``devices``: one ``torch.device`` per block (default: every block on
    ``b.device``); each block's iterate lives there and its thread runs
    in a CUDA stream of its own on a card.  ``sweep_delay_s``: an
    optional per-block delay after each sweep, the analog of the
    reference's ``tc``-throttled WAN experiments
    (``running_bulk_test_local:322-330``), for convergence under blocks
    of unequal speed.  ``outer`` is accepted for the JAX signature: the
    minimizations here solve their own small systems.

    ``intra``: shards per block (the reference's npb ranks per block,
    ``iSolve --npb``).  With ``intra > 1`` each block's thread drives a
    sharded inner GMRES over its own ``('intra',)`` sub-mesh on the
    ``'local'`` transport (``parallel.mesh``): ppermute halos and psum
    dots inside the block, on the block's device and stream, while the
    blocks stay asynchronous through the mailboxes.  Stencil block
    operators, AM only (no minimization), as in the JAX package.
    """
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    if inner.pc != "none":
        # fail loudly rather than silently dropping the PC (this
        # backend builds its own plain-GMRES sweeps)
        raise ValueError(
            "host_async backend does not implement inner "
            f"preconditioning (got pc={inner.pc!r}); use the stacked "
            "backend for --inner-pc-type")
    opcfg = _intra_config(op, intra, minimization) if intra > 1 else None
    nb, bs = op.nblocks, op.block_size
    dtype = b.dtype
    np_dtype = _np_dtype(dtype)
    if devices is None:
        devices = [b.device] * nb
    devices = [torch.device(d) for d in devices]
    if len(devices) != nb:
        raise ValueError(f"devices needs {nb} entries, got {len(devices)}")
    if sweep_delay_s is None:
        sweep_delay_s = [0.0] * nb

    rnorm0 = float(torch.linalg.norm(b.reshape(-1)))
    tol_local = max(rtol / np.sqrt(nb) * rnorm0, atol)

    # each block's copy of b on its device; the threads only read them
    bks = [b.to(devices[k]) for k in range(nb)]
    for d in {d for d in devices if d.type == "cuda"}:
        _init_linalg(d, dtype)
        torch.cuda.synchronize(d)

    # shared state -------------------------------------------------------
    mailboxes = [_Mailbox() for _ in range(nb)]   # published block iterates
    gram_boxes = [_Mailbox() for _ in range(nb)]  # published (G, c) panels
    transport = LocalTransport(nb)
    all_ranks = list(range(nb))
    nodes = [
        Alg515Node(r, [x for x in all_ranks if x != r], transport,
                   persistence=min_convergence_count)
        for r in all_ranks
    ]
    x_final: List[Optional[np.ndarray]] = [None] * nb
    sweeps_done = [0] * nb
    for k in range(nb):
        mailboxes[k].publish(np.zeros((bs,), np_dtype))

    stop = threading.Event()
    errors: List[BaseException] = []

    def block_worker(k: int):
        dev = devices[k]
        on_card = dev.type == "cuda"
        ctx = contextlib.ExitStack()
        try:
            with ctx:
                if on_card:
                    ctx.enter_context(torch.cuda.device(dev))
                    ctx.enter_context(torch.cuda.stream(
                        torch.cuda.Stream(dev)))
                b_k = bks[k]
                mv = _block_mv(op, k)
                sweep = (_gmres_sweep(mv, inner) if opcfg is None
                         else _sharded_sweep(opcfg, intra, inner, dev))
                x = torch.zeros((bs,), dtype=dtype, device=dev)
                node = nodes[k]
                peer_versions = {j: 0 for j in all_ranks if j != k}
                S_buf = []
                while (node.state is not State.FINISHED
                       and not stop.is_set()):
                    if sweeps_done[k] >= maxiter:
                        break
                    # drain-to-newest: every peer's latest published value
                    stack_np = np.empty((nb, bs), np_dtype)
                    fresh = []
                    for j in range(nb):
                        if j == k:
                            stack_np[j] = 0.0
                            continue
                        val, ver = mailboxes[j].read()
                        stack_np[j] = val
                        if ver > peer_versions[j]:
                            fresh.append(j)
                            peer_versions[j] = ver
                    x_stack = torch.from_numpy(stack_np).to(dev)
                    rhs = b_k[k] - op.coupling_mv(x_stack)[k]
                    x, pre_norm = sweep(rhs, x)
                    sweeps_done[k] += 1

                    if minimization == "local":
                        S_buf.append(x)
                        if len(S_buf) == s:
                            x = _minimize_local(mv, torch.stack(S_buf), rhs)
                            S_buf = []
                    elif minimization in ("semi_local", "global"):
                        # full-length snapshot: own part + latest peer parts
                        snap = stack_np.copy()
                        snap[k] = x.cpu().numpy()
                        S_buf.append(snap)
                        if len(S_buf) == s:
                            S_full = torch.from_numpy(np.stack(S_buf)).to(dev)
                            G, c = (t.cpu().numpy() for t in
                                    _gram_contrib(op, b_k, k, S_full))
                            if minimization == "global":
                                # async Gram exchange: publish own panel,
                                # use the newest peer panels available
                                # (stale OK -- comm_async_*_min semantics)
                                gram_boxes[k].publish((G, c))
                                Gt, ct = G.copy(), c.copy()
                                for j in all_ranks:
                                    if j == k:
                                        continue
                                    val, _ = gram_boxes[j].read()
                                    if val is not None:
                                        Gt += val[0]
                                        ct += val[1]
                                alpha = _solve_gram_np(Gt, ct)
                            else:
                                alpha = _solve_gram_np(G, c)
                            x = _combine(S_full[:, k, :], torch.as_tensor(
                                alpha, dtype=dtype, device=dev))
                            S_buf = []

                    mailboxes[k].publish(x.cpu().numpy())
                    under = bool(float(pre_norm) <= tol_local)
                    node.step(under_threshold=under, fresh_from=fresh)
                    if sweep_delay_s[k]:
                        time.sleep(sweep_delay_s[k])
                # pump remaining protocol traffic so peers can finish
                deadline = time.time() + 5.0
                while (node.state is not State.FINISHED
                       and time.time() < deadline):
                    if all(nodes[j].state is State.FINISHED
                           or sweeps_done[j] >= maxiter for j in all_ranks):
                        break
                    node.pump()
                    time.sleep(0.001)
                x_final[k] = x.cpu().numpy()
        except BaseException as e:  # surface worker failures to the caller
            errors.append(e)
            stop.set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=block_worker, args=(k,), daemon=True)
               for k in range(nb)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + join_timeout_s
    for t in threads:
        t.join(timeout=max(0.1, deadline - time.monotonic()))
    hung = [i for i, t in enumerate(threads) if t.is_alive()]
    elapsed = time.perf_counter() - t0
    if hung:
        stop.set()
        raise TimeoutError(
            f"host_async block workers {hung} still running after "
            f"join_timeout_s={join_timeout_s}")
    if errors:
        raise errors[0]

    x = torch.from_numpy(np.stack([
        x_final[k] if x_final[k] is not None else np.zeros((bs,), np_dtype)
        for k in range(nb)])).to(b.device)
    converged = all(n.state is State.FINISHED for n in nodes)
    certified, tail_rounds = False, 0
    if converged:
        x, certified, tail_rounds = _sync_certify(op, b, x, tol_local, inner)
    r = b - op.full_mv(x)
    rnorm = float(torch.linalg.norm(r.reshape(-1)))
    return HostAsyncResult(
        x=x, sweeps_per_block=list(sweeps_done), rnorm=rnorm,
        rnorm0=rnorm0, converged=converged, elapsed_s=elapsed,
        certified=certified, tail_rounds=tail_rounds)
