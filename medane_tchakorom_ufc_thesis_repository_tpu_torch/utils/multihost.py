"""Multi-process execution (port of the JAX package's
``utils/multihost.py``): the analog of the reference's ``mpiexec``
fan-out (``iSolve:347-401``).

* ``launch(...)``: the parent's fan-out: N processes of ``python -m
  ...utils.multihost`` with one coordinator address (on a cluster each
  host runs the worker command itself with its own ``--process-id``).
  The ranks are new interpreters, never forks, so no CUDA state crosses
  into them.
* ``worker_main(argv)``: one rank: ``torch.distributed`` initialised over
  TCP (``parallel.mesh.init_multihost``), the ``'dist'`` mesh over every
  process (``make_multihost_mesh``), the requested algorithm through the
  sharded entry points, one JSON line on standard output.

Every collective of the solve then crosses the process boundary: gloo
on the CPU or on a card the ranks share, NCCL with a card a rank.
``free_port``, ``scrubbed_env``, ``repo_root`` and ``run_ranks`` are
shared with ``models.net_async.launch_net_async``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    """A localhost port that was free a moment ago (racy under parallel
    launchers: ``launch_net_async`` retries the two race symptoms)."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scrubbed_env(device: str = "cuda") -> dict:
    """Environment for a worker process: this process's own, and for a
    CPU worker one OpenMP and PyTorch thread (``OMP_NUM_THREADS=1``), so
    that several ranks, and several test workers, do not oversubscribe
    the cores."""
    env = dict(os.environ)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    return env


def repo_root() -> str:
    """The directory that holds the port's package (the checkout's root
    when run from a checkout): the workers' working directory, so that
    ``python -m`` imports this copy of the port."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_ranks(cmds: Sequence[Sequence[str]], env: dict, *,
              timeout_s: float, label: str) -> List[dict]:
    """Start one subprocess per command, collect all under a SHARED
    deadline (kill and mark on expiry), raise ``RuntimeError`` with the
    combined output if any rank fails (the analog of mpiexec's nonzero
    exit on any-rank failure), and parse each rank's last JSON line of
    standard output."""
    procs = [
        subprocess.Popen(list(cmd), env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         cwd=repo_root())
        for cmd in cmds
    ]
    outs, rcs = [], []
    deadline = time.monotonic() + timeout_s
    for p in procs:
        left = max(1.0, deadline - time.monotonic())
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[parent] TIMEOUT"
        outs.append(out)
        rcs.append(p.returncode)
    if any(rc != 0 for rc in rcs):
        blob = "\n".join(f"--- rank {i} rc={rc}\n{o}"
                         for i, (rc, o) in enumerate(zip(rcs, outs)))
        raise RuntimeError(f"{label} launch failed:\n{blob}")
    results = []
    for i, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith("{")]
        if not line:
            raise RuntimeError(f"rank {i} produced no JSON:\n{out}")
        results.append(json.loads(line[-1]))
    return results


def launch(worker_args: Sequence[str], *, num_processes: int = 2,
           device: str = "cuda", backend: str = "gloo",
           timeout_s: float = 600.0, port: Optional[int] = None) -> List[dict]:
    """Start ``num_processes`` ranks running ``worker_main`` with the solve
    flags ``worker_args`` on ``device`` ('cuda', the default, or 'cpu')
    over ``backend``; returns each rank's parsed JSON line.  One retry on a
    fresh port covers the race of ``free_port`` with another process
    binding the probed port first."""
    env = scrubbed_env(device)

    def attempt(p):
        cmds = [[sys.executable, "-m",
                 "medane_tchakorom_ufc_thesis_repository_tpu_torch.utils."
                 "multihost",
                 "--coordinator", f"localhost:{p}",
                 "--num-processes", str(num_processes),
                 "--process-id", str(pid), "--device", device,
                 "--backend", backend, *worker_args]
                for pid in range(num_processes)]
        return run_ranks(cmds, env, timeout_s=timeout_s, label="multihost")

    try:
        return attempt(port or free_port())
    except RuntimeError as e:
        if port is None and "address already in use" in str(e).lower():
            return attempt(free_port())
        raise


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

KNOWN = ("GMRES", "MGPCG", "SM", "AM", "SMSM_LOCAL", "SMSM_SEMI_LOCAL",
         "SMSM_GLOBAL", "AMAM_LOCAL", "AMAM_SEMI_LOCAL", "AMAM_GLOBAL")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="multihost",
        description="One rank of a multi-process multisplitting solve")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--alg", default="SMSM_GLOBAL")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--m", type=int, default=32)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--nz", type=int, default=16)
    p.add_argument("--nblocks", type=int, default=2)
    # shards a block (default: the processes over the blocks, one shard
    # a process)
    p.add_argument("--intra", type=int, default=None)
    p.add_argument("--s", type=int, default=4)
    p.add_argument("--rtol", type=float, default=1e-4)
    p.add_argument("--maxiter", type=int, default=2000)
    p.add_argument("--staleness", type=int, default=2)
    # None = not set: the multisplitting inner solve and the MGPCG
    # preconditioner have different defaults (8/1e-6 vs 40/1e-5)
    p.add_argument("--inner-maxiter", type=int, default=None)
    p.add_argument("--inner-restart", type=int, default=8)
    p.add_argument("--inner-rtol", type=float, default=None)
    p.add_argument("--inner-ksp", default="gmres")
    p.add_argument("--inner-pc-type", default="none", dest="inner_pc")
    p.add_argument("--basis-collection", default="sweep",
                   dest="basis_collection")
    p.add_argument("--outer-method", default="qr")
    p.add_argument("--outer-maxiter", type=int, default=200)
    p.add_argument("--outer-rtol", type=float, default=1e-12)
    p.add_argument("--min-convergence-count", type=int, default=4)
    p.add_argument("--dtype", default="float64")
    # rank 0 writes the global x here (.npy)
    p.add_argument("--save-x", default=None)
    # after the solve: ring-shift rounds of a 1024-float payload along
    # 'block' (parallel.probe.measure_collective_latency), 0 = none
    p.add_argument("--probe-rounds", type=int, default=0)
    return p


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    alg = args.alg.upper()
    if alg not in KNOWN:
        # silently running another algorithm than configured corrupts
        # experiments
        raise SystemExit(f"multihost worker does not implement --alg {alg}; "
                         f"supported: {', '.join(KNOWN)}")

    import numpy as np
    import torch
    import torch.distributed as dist

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
        InnerConfig,
        OuterConfig,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
        ShardedPoisson2D,
        ShardedPoisson3D,
        init_multihost,
        make_multihost_mesh,
        sharded_df_northstar,
        sharded_gmres_solve,
        sharded_mgpcg_solve,
        sharded_multisplit_solve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.probe import (
        measure_collective_latency,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64

    if args.device == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        # one card a rank under NCCL; under gloo the ranks may share one
        ndev = torch.cuda.device_count()
        device = torch.device("cuda", args.process_id % ndev
                              if args.backend == "nccl" else 0)
        torch.cuda.set_device(device)
    t_start = time.perf_counter()
    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   backend=args.backend)
    mesh = make_multihost_mesh(args.nblocks, args.intra, device=device)
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    opcfg = (ShardedPoisson2D(args.m, args.n) if args.dim == 2
             else ShardedPoisson3D(args.m, args.n, args.nz))
    # b = A 1 (exact solution 1), built whole on every process
    b = _global_stencil_apply(
        opcfg, torch.ones(opcfg.global_shape, dtype=dtype, device=device))
    dist.barrier()
    startup = time.perf_counter() - t_start

    err = None
    t0 = time.perf_counter()
    if alg == "GMRES":
        res = sharded_gmres_solve(mesh, opcfg, b, restart=30,
                                  maxiter=args.maxiter, rtol=args.rtol)
        sweeps, cycles, inner_iters = int(res.iters), 0, int(res.iters)
        rnorm, rnorm0, x = float(res.resnorm), float(res.resnorm0), res.x
    elif alg == "MGPCG":
        mg_kw = {}
        if args.inner_rtol is not None:
            mg_kw["inner_rtol"] = args.inner_rtol
        if args.inner_maxiter is not None:
            mg_kw["pcg_maxiter"] = args.inner_maxiter
        if dtype == torch.float32 and args.rtol < 1e-5:
            res = sharded_df_northstar(mesh, opcfg, rtol=args.rtol, **mg_kw)
            sweeps, cycles, inner_iters = 0, int(res.passes), 0
            rnorm, rnorm0 = float(res.rnorm), float(res.rnorm0)
            err = float(np.abs(df64.df_to_f64(res.x) - 1.0).max())
            x = res.x[0]
        else:
            if mg_kw:
                raise SystemExit(
                    "--inner-rtol/--inner-maxiter configure the PCG inside "
                    "df refinement; this run takes the plain MGPCG branch "
                    "(f64 or rtol >= 1e-5) where they do not apply")
            res = sharded_mgpcg_solve(mesh, opcfg, b, rtol=args.rtol,
                                      maxiter=args.maxiter)
            sweeps, cycles, inner_iters = int(res.iters), 0, int(res.iters)
            rnorm, rnorm0, x = float(res.resnorm), float(res.resnorm0), res.x
    else:
        schedule = "async" if alg.startswith("A") else "sync"
        minim = (None if alg in ("SM", "AM") else
                 {"L": "local", "S": "semi_local", "G": "global"}[
                     alg.split("_", 1)[1][0]])
        res = sharded_multisplit_solve(
            mesh, opcfg, b, schedule=schedule,
            staleness=args.staleness if schedule == "async" else 1,
            minimization=minim, s=args.s,
            inner=InnerConfig(
                method=args.inner_ksp, pc=args.inner_pc,
                restart=args.inner_restart,
                maxiter=8 if args.inner_maxiter is None
                else args.inner_maxiter,
                rtol=1e-6 if args.inner_rtol is None else args.inner_rtol),
            outer=OuterConfig(method=args.outer_method,
                              maxiter=args.outer_maxiter,
                              rtol=args.outer_rtol),
            rtol=args.rtol, maxiter=args.maxiter,
            min_convergence_count=args.min_convergence_count,
            basis_collection=args.basis_collection)
        sweeps, cycles = int(res.sweeps), int(res.cycles)
        inner_iters = int(res.inner_iters)
        rnorm, rnorm0, x = float(res.rnorm), float(res.rnorm0), res.x
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    if err is None:
        err = float((x - 1.0).abs().max())
    if args.save_x and args.process_id == 0:
        np.save(args.save_x, x.cpu().numpy())
    out = {"alg": alg, "process_id": args.process_id,
           "num_processes": args.num_processes, "backend": args.backend,
           "device": str(device), "mesh": list(mesh.global_shape),
           "local_shards": list(mesh.local_shape), "sweeps": sweeps,
           "cycles": cycles, "inner_iters": inner_iters, "rnorm": rnorm,
           "rnorm0": rnorm0, "converged": bool(res.converged),
           "err_vs_ones": err, "startup_s": startup, "elapsed_s": elapsed}
    if args.probe_rounds:
        out["collective_block"] = measure_collective_latency(
            mesh, "block", rounds=args.probe_rounds)
    # every rank leaves its last collective before any tears down the
    # group; a gloo group left to the interpreter's exit can abort it
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def _global_stencil_apply(opcfg, g):
    """The whole grid's stencil apply on every process (for b = A 1)."""
    y = opcfg.interior_mv(g.reshape(1, opcfg.split_extent, opcfg.fdim))
    return y.reshape(g.shape)


if __name__ == "__main__":
    sys.exit(worker_main())
