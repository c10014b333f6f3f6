"""``isolve``-equivalent command line of the port: one launcher for the
whole algorithm zoo (port of the JAX package's ``utils/cli.py``, flag for
flag, with the same JSON record keys plus ``device``).

The reference's ``iSolve`` launcher (SURVEY.md §2.6),
``./iSolve --alg SMSM_GLOBAL --np 8 --npb 4 --m 200 --n 200 --rtol 1e-3``,
becomes::

    python -m medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.cli \
        --alg SMSM_GLOBAL --m 200 --n 200 --rtol 1e-3 [--backend sharded
        --nblocks 2 --intra 4]

(or ``isolve_torch ...`` once the package is installed).  The run builds
on the card unless ``--device cpu`` asks for the host, where the kernels'
plain PyTorch versions run; without a card and without ``--device cpu``
it raises.  Prints the end-of-run report of the reference binaries
(``printResidualNorm`` / ``printElapsedTime`` / ``computeError``,
reference ``src/utils/utils.c:668-729,1045-1059``): initial and final true
residual norm, sweep and inner-iteration counts, elapsed seconds, and the
error against the exact solution u = 1.  Exit code 0 when the run
converged, 2 when it did not.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# the JAX CLI's --devices-per-process default, the one value accepted
DEVICES_PER_PROCESS = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="isolve_torch",
        description="two-stage multisplitting solver launcher (PyTorch/CUDA "
                    "port; runs on the card unless --device cpu)",
    )
    p.add_argument("--alg", default="SM",
                   help="GMRES | CA_GMRES | MGPCG | SM | AM | "
                        "SMSM_{LOCAL,SEMI_LOCAL,GLOBAL} | "
                        "AMAM_{LOCAL,SEMI_LOCAL,GLOBAL}")
    p.add_argument("--config", default=None,
                   help="JSON config file (defaults < file < CLI)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the run builds its tensors: the current "
                        "CUDA device (the default; an error without a "
                        "card) or the host, where the kernels' plain "
                        "PyTorch versions run")
    p.add_argument("--dim", type=int, default=None, help="2 or 3")
    p.add_argument("--matrix", default=None, metavar="PATH",
                   help="solve a user-supplied square sparse matrix "
                        "(.npz from scipy.sparse.save_npz, or "
                        "MatrixMarket .mtx) instead of the Poisson "
                        "generators; b = A*1. Works with GMRES (stacked "
                        "+ row-sharded), CA_GMRES (stacked; Lanczos-"
                        "estimated interval), and the multisplitting "
                        "algorithms; the block split auto-routes to "
                        "DIA/BSR/ELL (create_matrix_sparse parity)")
    p.add_argument("--m", type=int, default=None, help="grid rows (2D) / nx (3D)")
    p.add_argument("--n", type=int, default=None, help="grid cols (2D) / ny (3D)")
    p.add_argument("--nz", type=int, default=None, help="nz (3D)")
    p.add_argument("--s", type=int, default=None, help="basis depth")
    p.add_argument("--rtol", type=float, default=None)
    p.add_argument("--maxiter", type=int, default=None, help="sweep budget")
    p.add_argument("--min-convergence-count", type=int, default=None,
                   dest="min_convergence_count")
    p.add_argument("--staleness", type=int, default=None,
                   help="async publish period (sweeps)")
    p.add_argument("--basis-collection", default=None,
                   dest="basis_collection", choices=["sweep", "publish"],
                   help="async s-step basis: per-sweep (thesis-faithful) "
                        "or per-publish (staleness-robust)")
    p.add_argument("--nblocks", type=int, default=None,
                   help="Jacobi blocks (np/npb analog)")
    p.add_argument("--intra", type=int, default=None,
                   help="devices per block (sharded backend)")
    # the reference launcher's decomposition flags (iSolve:118-194): --np
    # total workers, --npb workers a block => nblocks = np/npb,
    # intra = npb.  Aliases for users switching from ./iSolve.
    p.add_argument("--np", type=int, default=None, dest="np_flag",
                   help="iSolve parity: total workers (= nblocks*npb)")
    p.add_argument("--npb", type=int, default=None, dest="npb_flag",
                   help="iSolve parity: workers per block (= intra)")
    p.add_argument("--backend", default=None,
                   choices=["stacked", "sharded", "tiled", "host_async"])
    p.add_argument("--ir", type=int, default=None,
                   help="row tiles per block (tiled backend)")
    p.add_argument("--ic", type=int, default=None,
                   help="column tiles (tiled backend)")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"])
    p.add_argument("--pc-type", default=None, dest="pc_type",
                   choices=["none", "jacobi", "bjacobi", "amg"],
                   help="whole-system PC for the GMRES baseline on a "
                        "user matrix (--alg GMRES --matrix): jacobi = "
                        "diagonal scaling; bjacobi = batched dense "
                        "block inverses (PCBJACOBI analog); amg = "
                        "smoothed-aggregation multigrid (PCGAMG analog, "
                        "SPD systems; stacked backend)")
    p.add_argument("--pc-block-size", type=int, default=None,
                   dest="pc_block_size",
                   help="bjacobi diagonal-block size (default 64)")
    p.add_argument("--inner-restart", type=int, default=None, dest="inner_restart")
    p.add_argument("--inner-maxiter", type=int, default=None, dest="inner_maxiter")
    p.add_argument("--inner-rtol", type=float, default=None, dest="inner_rtol")
    p.add_argument("--inner-ksp", default=None, dest="inner_ksp",
                   choices=["gmres", "cg", "bicgstab", "chebyshev",
                            "ca_gmres"])
    p.add_argument("--inner-pc-type", default=None, dest="inner_pc",
                   choices=["none", "jacobi", "bjacobi", "mg"])
    p.add_argument("--inner-pc-block-size", type=int, default=None,
                   dest="inner_pc_block_size",
                   help="inner pc=bjacobi diagonal-sub-block size "
                        "(default 64)")
    p.add_argument("--inner-basis", default=None, dest="inner_basis",
                   choices=["native", "bf16"],
                   help="Krylov-basis storage (bf16 halves bandwidth)")
    p.add_argument("--outer-method", default=None, dest="outer_method",
                   choices=["qr", "normal", "lsqr", "cgne"])
    p.add_argument("--outer-maxiter", type=int, default=None, dest="outer_maxiter")
    p.add_argument("--outer-rtol", type=float, default=None, dest="outer_rtol")
    # per-block prefixed KSP options, the reference's inner1_/inner2_/
    # outer1_/outer2_ PETSc prefixes (utils.c:512-541, iSolve:118-194);
    # each overrides the shared --inner-*/--outer-* base for that block
    # only (stacked backend)
    for blk in (1, 2):
        p.add_argument(f"--inner{blk}-ksp", default=None,
                       dest=f"inner{blk}_ksp",
                       choices=["gmres", "cg", "bicgstab", "chebyshev",
                                "ca_gmres"])
        p.add_argument(f"--inner{blk}-restart", type=int, default=None,
                       dest=f"inner{blk}_restart")
        p.add_argument(f"--inner{blk}-maxiter", type=int, default=None,
                       dest=f"inner{blk}_maxiter")
        p.add_argument(f"--inner{blk}-rtol", type=float, default=None,
                       dest=f"inner{blk}_rtol")
        p.add_argument(f"--inner{blk}-pc-type", default=None,
                       dest=f"inner{blk}_pc",
                       choices=["none", "jacobi", "bjacobi", "mg"])
        p.add_argument(f"--outer{blk}-method", default=None,
                       dest=f"outer{blk}_method",
                       choices=["qr", "normal", "lsqr", "cgne"])
        p.add_argument(f"--outer{blk}-maxiter", type=int, default=None,
                       dest=f"outer{blk}_maxiter")
        p.add_argument(f"--outer{blk}-rtol", type=float, default=None,
                       dest=f"outer{blk}_rtol")
    p.add_argument("--show-config", action="store_true", dest="show_config",
                   help="print the fully-resolved run configuration "
                        "(defaults < file < CLI) before solving — the "
                        "PETSc -options_view analog")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line instead of the report")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here")
    p.add_argument("--stage-timers", action="store_true", dest="stage_timers",
                   help="host-stepped solve with per-stage wall timers "
                        "(I_Solver/Exchange/O_Solver/Convergence — the "
                        "PetscLog-stage analog; stacked backend)")
    p.add_argument("--flame", default=None, metavar="PATH", dest="flame",
                   help="write the stage timers: .html flamegraph, "
                        ".txt folded stacks, .xml nested-timer report "
                        "with companion XSL (-log_view ::ascii_xml "
                        "analog); otherwise a flamegraph-style "
                        "HTML artifact (the performance_xml2html.xsl / "
                        "-log_view ::ascii_flamegraph analog); implies "
                        "--stage-timers for .html, or folded-stack text "
                        "for a .txt path")
    p.add_argument("--record-history", action="store_true",
                   dest="record_history",
                   help="record + report per-cycle residual norms (the "
                        "reference's per-iteration norm printouts)")
    p.add_argument("--net-async", type=int, default=None, metavar="NPROCS",
                   dest="net_async",
                   help="run AM with NPROCS OS processes (one Jacobi "
                        "block each) exchanging iterates + Alg-5.15 "
                        "termination over TCP sockets (the reference's "
                        "inter-node async execution model)")
    p.add_argument("--transport", default=None,
                   choices=["auto", "python", "native"],
                   help="net-async wire transport: pure-Python sockets or "
                        "the C++ epoll router (native/src/comm.cpp); "
                        "auto prefers native when it builds")
    p.add_argument("--termination", default=None,
                   choices=["protocol", "traversal", "slcv"],
                   help="net-async termination: Alg-5.15 protocol, the "
                        "legacy 2x-traversal-time quiet-window guard "
                        "(asynchronous-multisplitting.c.save:307-329), or "
                        "the legacy SLCV counter protocol "
                        "(conv_detection.c:6-196)")
    p.add_argument("--wan-latency-ms", type=float, default=0.0,
                   dest="wan_latency_ms",
                   help="net-async WAN emulation: one-way link latency "
                        "(the reference's tc-qdisc study analog; see "
                        "also utils.wan_study)")
    p.add_argument("--wan-bw-mbit", type=float, default=0.0,
                   dest="wan_bw_mbit",
                   help="net-async WAN emulation: link bandwidth Mbit/s")
    p.add_argument("--multihost", type=int, default=None, metavar="NPROCS",
                   help="fan out NPROCS OS processes over torch.distributed "
                        "(the reference's mpiexec analog, iSolve:347-401); "
                        "gloo, the ranks on the run's device (they share "
                        "card 0)")
    p.add_argument("--devices-per-process", type=int,
                   default=DEVICES_PER_PROCESS, dest="devices_per_process",
                   help="the JAX package's virtual CPU devices per "
                        "multihost process; no twin here (each rank holds "
                        "its share of the mesh's shards on one device), "
                        f"so only {DEVICES_PER_PROCESS} is accepted")
    return p


_MULTIHOST_PASSTHROUGH = {
    "alg": "--alg", "dim": "--dim", "m": "--m", "n": "--n", "nz": "--nz",
    "nblocks": "--nblocks", "s": "--s", "rtol": "--rtol",
    "maxiter": "--maxiter", "staleness": "--staleness",
    "inner_maxiter": "--inner-maxiter", "inner_restart": "--inner-restart",
    "inner_rtol": "--inner-rtol", "inner_ksp": "--inner-ksp",
    "inner_pc": "--inner-pc-type",
    "basis_collection": "--basis-collection",
    "outer_method": "--outer-method", "outer_maxiter": "--outer-maxiter",
    "outer_rtol": "--outer-rtol",
    "min_convergence_count": "--min-convergence-count", "dtype": "--dtype",
}

# solver options the worker parser does NOT implement: reject loudly
# instead of silently running another configuration than requested
_MULTIHOST_UNSUPPORTED = ("inner_basis", "ir", "ic", "intra")


def run_multihost(args) -> dict:
    """Parent side of a multi-process run: fan out worker ranks on
    ``--device`` and return rank 0's result (all ranks' replicated
    scalars agree).  ``utils.multihost.launch`` waits for every rank, and
    each rank barriers and destroys its process group before it prints."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import (
        resolve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import multihost

    for field in _MULTIHOST_UNSUPPORTED:
        if getattr(args, field, None) is not None:
            raise SystemExit(
                f"--multihost does not implement --{field.replace('_', '-')}"
            )
    pb = [f for f in vars(args)
          if (f.startswith(("inner1_", "inner2_", "outer1_", "outer2_"))
              and getattr(args, f) is not None)]
    if pb:
        raise SystemExit(
            f"--multihost does not implement per-block flags: {pb}"
        )
    wargs = []
    for field, flag in _MULTIHOST_PASSTHROUGH.items():
        v = getattr(args, field, None)
        if v is not None:
            wargs += [flag, str(v)]
    results = multihost.launch(
        wargs, num_processes=args.multihost, device=resolve(args.device).type,
    )
    out = dict(results[0])
    out["backend"] = f"multihost({args.multihost}proc)"
    return out


_PER_BLOCK_KEYS = ("ksp", "restart", "maxiter", "rtol", "pc")
_PER_BLOCK_OUTER_KEYS = ("method", "maxiter", "rtol")


def _collect_per_block(args):
    """--inner1-*/--outer2-*-style flags -> override dict lists."""
    inner, outer = [], []
    for blk in (1, 2):
        inner.append({
            k: v for k in _PER_BLOCK_KEYS
            if (v := getattr(args, f"inner{blk}_{k}", None)) is not None
        })
        outer.append({
            k: v for k in _PER_BLOCK_OUTER_KEYS
            if (v := getattr(args, f"outer{blk}_{k}", None)) is not None
        })
    return inner, outer


def run_net_async(args) -> dict:
    """TCP-async fan-out: one OS process per Jacobi block on ``--device``,
    iterates + Alg-5.15 termination over sockets (models.net_async).  AM
    and the async-minimization variants AMAM_{LOCAL,SEMI_LOCAL,GLOBAL}
    (Gram panels ride the latest-wins DATA frames); SM and SMSM_* as
    lockstep rounds over the same sockets."""
    import numpy as np
    import torch

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import (
        resolve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.net_async import (
        launch_net_async,
    )

    alg = args.alg or "AM"
    minim_map = {
        "AM": (None, "async"),
        "AMAM_LOCAL": ("local", "async"),
        "AMAM_SEMI_LOCAL": ("semi_local", "async"),
        "AMAM_GLOBAL": ("global", "async"),
        # sync lockstep rounds over the same sockets: the sync baselines
        # of the WAN study (utils.wan_study)
        "SM": (None, "sync"),
        "SMSM_LOCAL": ("local", "sync"),
        "SMSM_SEMI_LOCAL": ("semi_local", "sync"),
        "SMSM_GLOBAL": ("global", "sync"),
    }
    if alg not in minim_map:
        raise SystemExit(
            "--net-async runs AM | AMAM_{LOCAL,SEMI_LOCAL,GLOBAL} "
            "(async) or SM | SMSM_{LOCAL,SEMI_LOCAL,GLOBAL} (sync "
            "lockstep over TCP)"
        )
    minimization, schedule = minim_map[alg]
    device = resolve(args.device)
    m = args.m or 64
    n = args.n or 64
    results = launch_net_async(
        nblocks=args.net_async, m=m, n=n,
        rtol=args.rtol or 1e-4, maxiter=args.maxiter or 4000,
        min_convergence_count=args.min_convergence_count or 4,
        inner_maxiter=args.inner_maxiter or 20,
        dtype=args.dtype or "float64",
        termination=args.termination or "protocol",
        transport=args.transport or "auto",
        minimization=minimization,
        s=4 if args.s is None else args.s,
        schedule=schedule,
        wan_latency_ms=args.wan_latency_ms or 0.0,
        wan_bw_mbit=args.wan_bw_mbit or 0.0,
        device=device.type,
    )
    # the merged iterate's true residual, in f64 on the run's device
    op = blockops.block_poisson2d(m, n, nblocks=args.net_async)
    b = blockops.rhs_ones(op, torch.float64, device)
    x = torch.from_numpy(np.stack([
        np.asarray(r["x_block"], np.float64)
        for r in sorted(results, key=lambda r: r["rank"])
    ])).to(device)
    r_true = b - op.full_mv(x)
    rnorm = float(torch.linalg.vector_norm(r_true.reshape(-1)))
    return {
        "alg": alg, "backend": f"net_async({args.net_async}proc tcp)",
        "grid": f"{m}x{n}", "dim": 2,
        "sweeps_per_block": [r["sweeps"] for r in results],
        "converged": all(r["converged"] for r in results),
        # True: the lockstep tail certified the merged residual <=
        # rtol*||b|| exactly; None under the legacy traversal guard
        "certified": (None if any(r["certified"] is None for r in results)
                      else all(r["certified"] for r in results)),
        "rnorm": rnorm, "rnorm0": results[0]["rnorm0"],
        "rel_rnorm": rnorm / results[0]["rnorm0"],
        "elapsed_s": max(r["elapsed_s"] for r in results),
        "error_vs_ones": float((x - 1.0).abs().max()),
        "device": str(device),
    }


def config_from_args(args) -> "RunConfig":
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.config import (
        default_config,
        load_config,
    )

    # ./iSolve parity: --np/--npb derive the mesh decomposition
    # (nblocks = np/npb, intra = npb; validation mirrors iSolve:332-338)
    if args.npb_flag is not None or args.np_flag is not None:
        if args.np_flag is None or args.npb_flag is None:
            raise SystemExit("--np and --npb must be given together")
        if args.npb_flag < 1 or args.np_flag % args.npb_flag:
            raise SystemExit(
                f"--np {args.np_flag} not divisible by --npb {args.npb_flag}"
            )
        if args.nblocks is None:
            args.nblocks = args.np_flag // args.npb_flag
        if args.intra is None:
            args.intra = args.npb_flag

    inner_pb, outer_pb = _collect_per_block(args)
    pb_keys = {
        f"{kind}{blk}_{k}"
        for blk in (1, 2)
        for kind, keys in (("inner", _PER_BLOCK_KEYS),
                           ("outer", _PER_BLOCK_OUTER_KEYS))
        for k in keys
    }
    overrides = {
        k: v for k, v in vars(args).items()
        if v is not None and k not in (
            {"config", "json", "profile_dir", "multihost",
             "devices_per_process", "stage_timers", "record_history",
             "net_async", "show_config", "np_flag", "npb_flag",
             "transport", "termination", "flame",
             "wan_latency_ms", "wan_bw_mbit"}
            | pb_keys
        )
    }
    if args.config:
        cfg = load_config(args.config, **overrides)
    else:
        cfg = default_config(**overrides)
    if any(inner_pb) or any(outer_pb):
        # pad the 1/2-indexed flag dicts to nblocks entries ({} = keep base)
        pad = [{} for _ in range(max(0, cfg.nblocks - 2))]
        cfg = dataclasses.replace(
            cfg,
            inner_overrides=(tuple(inner_pb[:cfg.nblocks] + pad)
                             if any(inner_pb) else None),
            outer_overrides=(tuple(outer_pb[:cfg.nblocks] + pad)
                             if any(outer_pb) else None),
        ).validate()
    return cfg


def _read_matrix(path: str):
    """The user matrix as scipy CSR: a ``save_npz`` file or MatrixMarket."""
    import scipy.sparse as sp

    if path.endswith(".npz"):
        return sp.load_npz(path)
    if path.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread

        return sp.csr_matrix(mmread(path))
    raise SystemExit(
        f"--matrix: unsupported extension on {path!r} "
        "(.npz from scipy.sparse.save_npz, or .mtx)"
    )


def _load_matrix_operator(path: str, nblocks: int, dtype, device):
    """Load a user sparse matrix and build the routed stacked operator
    on ``device`` (the ``create_matrix_sparse`` AIJ entry point,
    reference ``utils.c:139-155``) plus ``b = A·1`` in stacked layout."""
    import numpy as np
    import torch

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops

    A = _read_matrix(path)
    if A.shape[0] != A.shape[1]:
        raise SystemExit(f"--matrix must be square, got {A.shape}")
    if A.shape[0] % nblocks:
        raise SystemExit(
            f"--matrix rows ({A.shape[0]}) not divisible by "
            f"--nblocks ({nblocks})"
        )
    coo = A.tocoo()
    a_ii, a_ic = poisson.block_split_ell(
        coo.row, coo.col, coo.data, A.shape, nblocks=nblocks, dtype=dtype,
        device=device,
    )
    op = blockops.as_stacked_routed_operator(
        blockops.StackedELLOperator(a_ii=a_ii, a_ic=a_ic)
    )
    b = torch.as_tensor(
        np.asarray(A @ np.ones(A.shape[0])), dtype=dtype, device=device
    ).reshape(nblocks, A.shape[0] // nblocks)
    return op, b, A


def _krylov_record(kres) -> dict:
    return dict(sweeps=int(kres.iters), cycles=0,
                inner_iters=int(kres.iters),
                converged=bool(kres.converged),
                rnorm=float(kres.resnorm), rnorm0=float(kres.resnorm0))


def run(cfg, profile_dir=None, stage_timers=False, record_history=False):
    """Solve the configured problem on ``cfg``'s device; returns the
    result record and the ``PhaseTimer``."""
    import torch

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
        blockops,
        multisplitting as ms,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (
        PhaseTimer,
        fence,
        trace,
    )

    if stage_timers and (cfg.backend != "stacked"
                         or cfg.alg in ("GMRES", "CA_GMRES", "MGPCG")):
        raise SystemExit(
            "--stage-timers runs the host-stepped profiling driver "
            "(stacked backend, multisplitting algorithms only)"
        )
    if stage_timers and cfg.basis_collection == "publish":
        raise SystemExit(
            "--stage-timers (staged driver) does not implement "
            "--basis-collection publish — drop one of the two flags"
        )
    dev = cfg.torch_device()
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    pt = PhaseTimer()

    def make_mesh():
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
            make_mesh,
        )

        return make_mesh(nblocks=cfg.nblocks, intra=cfg.intra, device=dev)

    def make_tiled_mesh():
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
            make_tiled_mesh,
        )

        return make_tiled_mesh(cfg.nblocks, cfg.ir, cfg.ic, device=dev)

    def sharded_opcfg():
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
            ShardedPoisson2D,
            ShardedPoisson3D,
        )

        return (ShardedPoisson2D(cfg.m, cfg.n) if cfg.dim == 2
                else ShardedPoisson3D(cfg.m, cfg.n, cfg.nz))

    grid_label = (f"{cfg.m}x{cfg.n}" if cfg.dim == 2
                  else f"{cfg.m}x{cfg.n}x{cfg.nz}")
    with pt.phase("Loading"):
        if cfg.matrix:
            if cfg.backend != "stacked" and not (
                    cfg.backend == "sharded" and cfg.alg == "GMRES"):
                raise SystemExit(
                    "--matrix supports the stacked backend (all "
                    "algorithms) and --backend sharded with GMRES "
                    "(row-sharded general-sparse, parallel/general.py)"
                )
            if cfg.alg == "MGPCG":
                raise SystemExit(
                    "--matrix works with GMRES, CA_GMRES, and the "
                    "multisplitting algorithms (MGPCG is "
                    "geometric-multigrid/Poisson)"
                )
            if cfg.alg == "CA_GMRES" and cfg.backend != "stacked":
                raise SystemExit(
                    "--matrix with CA_GMRES runs on the stacked backend "
                    "(the sharded CA path is grid-structured)"
                )
            op, b, user_A = _load_matrix_operator(cfg.matrix, cfg.nblocks,
                                                  dtype, dev)
            grid_label = f"{os.path.basename(cfg.matrix)}:{user_A.shape[0]}"
        elif cfg.dim == 2:
            op = blockops.block_poisson2d(cfg.m, cfg.n, cfg.nblocks)
            b = blockops.rhs_ones(op, dtype, dev)
        else:
            op = blockops.block_poisson3d(cfg.m, cfg.n, cfg.nz, cfg.nblocks)
            b = blockops.rhs_ones(op, dtype, dev)
        fence(b)

    kw = dict(
        rtol=cfg.rtol, atol=cfg.atol, maxiter=cfg.maxiter,
        inner=cfg.inner_config(), outer=cfg.outer_config(),
        min_convergence_count=cfg.min_convergence_count,
    )

    if cfg.alg == "CA_GMRES":
        # communication-avoiding whole-system baseline: one collective
        # per s matvecs (solvers/castep.py; sharded_ca_gmres_solve)
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.castep import (
            ca_gmres,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
            poisson_strip_eig_bounds_2d,
            poisson_strip_eig_bounds_3d,
        )

        if cfg.matrix:
            # user matrix: estimate the interval by Lanczos (the PETSc
            # -ksp_chebyshev_esteig analog; SPD required: the Newton
            # shifts need a positive real interval)
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.eigest import (  # noqa: E501
                lanczos_bounds,
            )

            lmin, lmax = lanczos_bounds(
                op.global_mv, user_A.shape[0], dtype=dtype, device=dev,
            )
        elif cfg.dim == 2:
            lmin, lmax = poisson_strip_eig_bounds_2d(cfg.m, cfg.n, 4.0, -1.0)
        else:
            lmin, lmax = poisson_strip_eig_bounds_3d(
                cfg.m, cfg.n, cfg.nz, 6.0, -1.0
            )
        if cfg.backend == "sharded":
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
                sharded_ca_gmres_solve,
            )

            mesh = make_mesh()
            opcfg = sharded_opcfg()
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = sharded_ca_gmres_solve(
                    mesh, opcfg, b.reshape(opcfg.global_shape),
                    s=cfg.s, maxiter=cfg.maxiter, rtol=cfg.rtol,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
        elif cfg.backend == "stacked":
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = ca_gmres(
                    op.global_mv, b.reshape(-1), s=cfg.s,
                    maxiter=cfg.maxiter, rtol=cfg.rtol, lmin=lmin,
                    lmax=lmax,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x
        else:
            raise SystemExit(
                "CA_GMRES supports backends 'stacked' and 'sharded'"
            )
        result = _krylov_record(kres)
    elif cfg.alg == "GMRES":
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
            gmres,
        )

        if cfg.backend not in ("stacked", "sharded", "tiled"):
            raise SystemExit(
                "the GMRES baseline supports backends 'stacked', "
                "'sharded', and 'tiled'"
            )
        if cfg.backend == "tiled":
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
                tiled_gmres_solve,
            )

            if cfg.dim != 2:
                raise SystemExit("tiled GMRES is 2D (use sharded for 3D)")
            tmesh = make_tiled_mesh()
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = tiled_gmres_solve(
                    tmesh, cfg.m, cfg.n, b.reshape(cfg.m, cfg.n),
                    restart=cfg.inner_restart, maxiter=cfg.maxiter,
                    rtol=cfg.rtol,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
        elif cfg.backend == "sharded" and cfg.matrix:
            # row-sharded general-sparse GMRES (parallel/general.py): the
            # MPIAIJ-across-ranks analog for a user matrix
            import numpy as np

            from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.general import (
                shard_bjacobi_from_coo,
                shard_general_from_coo,
                sharded_general_solve,
            )

            mesh = make_mesh()
            ndev = cfg.nblocks * cfg.intra
            A = _read_matrix(cfg.matrix)
            coo = A.tocoo()
            cdata = coo.data
            b_vec = b.reshape(-1)
            gpc = None
            unscale = None
            if cfg.pc_type == "jacobi":
                # exact RIGHT point-Jacobi = column-scale the system on
                # the host (no run-time cost; convergence tests the true
                # residual; x = y / d afterwards)
                d = np.asarray(A.diagonal(), np.float64)
                d[d == 0] = 1.0
                cdata = coo.data / d[coo.col]
                unscale = torch.as_tensor(1.0 / d, dtype=dtype, device=dev)
            elif cfg.pc_type == "bjacobi":
                gpc = shard_bjacobi_from_coo(
                    coo.row, coo.col, coo.data, A.shape[0], ndev,
                    bs=cfg.pc_block_size, dtype=dtype, device=dev,
                )
            elif cfg.pc_type == "amg":
                raise SystemExit(
                    "--pc-type amg runs on the stacked backend (its "
                    "V-cycle levels are whole-system pytrees; the "
                    "row-sharded path offers jacobi/bjacobi)"
                )
            gop = shard_general_from_coo(
                coo.row, coo.col, cdata, A.shape[0], ndev, dtype=dtype,
                device=dev,
            )
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = sharded_general_solve(
                    mesh, gop, b_vec, method="gmres",
                    restart=cfg.inner_restart, maxiter=cfg.maxiter,
                    rtol=cfg.rtol, pc=gpc,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
            if unscale is not None:
                x_flat = unscale * x_flat
        elif cfg.backend == "sharded":
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
                sharded_gmres_solve,
            )

            mesh = make_mesh()
            opcfg = sharded_opcfg()
            b_grid = b.reshape(opcfg.global_shape)
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = sharded_gmres_solve(
                    mesh, opcfg, b_grid, restart=cfg.inner_restart,
                    maxiter=cfg.maxiter, rtol=cfg.rtol,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
        else:
            flat_b = b.reshape(-1)
            if cfg.matrix and cfg.pc_type != "none":
                # whole-system RIGHT PC on the user matrix (the outer
                # KSP's -pc_type; the reference gestures at the same side,
                # utils.c:524 KSPSetPCSide PC_RIGHT): solve (A M) y = b,
                # then x = M y, so the Givens estimate tracks the TRUE
                # residual
                if cfg.pc_type == "jacobi":
                    import numpy as np

                    d = np.asarray(user_A.diagonal(), np.float64)
                    d[d == 0] = 1.0
                    dinv = torch.as_tensor(1.0 / d, dtype=dtype, device=dev)

                    def M(v):
                        return dinv * v
                elif cfg.pc_type == "amg":
                    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.amg import (  # noqa: E501
                        amg_setup,
                    )

                    M = amg_setup(user_A, dtype=dtype, device=dev).apply
                else:
                    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.bjacobi import (  # noqa: E501
                        block_jacobi_from_scipy,
                    )

                    M = block_jacobi_from_scipy(
                        user_A, bs=cfg.pc_block_size, dtype=dtype,
                        device=dev,
                    ).apply

                def solve(bb):
                    res = gmres(
                        lambda v: op.global_mv(M(v)), bb,
                        restart=cfg.inner_restart,
                        maxiter=cfg.maxiter, rtol=cfg.rtol,
                    )
                    return dataclasses.replace(res, x=M(res.x))
            else:
                def solve(bb):
                    return gmres(
                        op.global_mv, bb, restart=cfg.inner_restart,
                        maxiter=cfg.maxiter, rtol=cfg.rtol,
                    )
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = solve(flat_b)
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x
        result = _krylov_record(kres)
    elif cfg.alg == "MGPCG":
        # multigrid-preconditioned CG on the whole system (the north-star
        # recipe as an algorithm): W-cycle preconditioning
        # (solvers/multigrid.py, the PCMG analog) and, for an rtol below
        # the f32 attainable-accuracy floor, double-float residual
        # refinement (solvers/df64.py), so that 1e-8..1e-12 relative
        # residuals are reachable from f32 solves
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.krylov import (
            cg as cg_solve,
        )

        gop = (poisson.poisson2d(cfg.m, cfg.n) if cfg.dim == 2
               else poisson.poisson3d(cfg.m, cfg.n, cfg.nz))
        gshape = ((cfg.m, cfg.n) if cfg.dim == 2
                  else (cfg.m, cfg.n, cfg.nz))
        b_grid = b.reshape(gshape)
        # the refinement's PCG takes the inner knobs (RunConfig's defaults
        # 1e-3 and 20, as in the JAX CLI)
        pcg_rtol = cfg.inner_rtol if cfg.inner_rtol is not None else 1e-5
        pcg_maxiter = cfg.inner_maxiter or 60
        want_refine = dtype == torch.float32 and cfg.rtol < 1e-5

        if cfg.backend in ("sharded", "tiled"):
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
                sharded_df_northstar,
                sharded_mgpcg_solve,
            )

            mesh = make_tiled_mesh() if cfg.backend == "tiled" else make_mesh()
            opcfg = sharded_opcfg()
            if want_refine:
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    rres = sharded_df_northstar(
                        mesh, opcfg, rtol=cfg.rtol,
                        inner_rtol=pcg_rtol, pcg_maxiter=pcg_maxiter,
                    )
                    fence(rres.x[0])
                    elapsed = time.perf_counter() - t0
            else:
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    kres = sharded_mgpcg_solve(
                        mesh, opcfg, b_grid, rtol=cfg.rtol,
                        maxiter=cfg.maxiter,
                    )
                    fence(kres.x)
                    elapsed = time.perf_counter() - t0
                x_flat = kres.x.reshape(-1)
        elif cfg.backend == "stacked":
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.multigrid import (
                mg_preconditioner,
            )

            M = mg_preconditioner(gop)
            if want_refine:
                from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
                    df_iterative_refinement,
                )

                def solve32(rr):
                    return cg_solve(gop.mv, rr, maxiter=pcg_maxiter,
                                    rtol=pcg_rtol, precond=M).x

                b_df = (b_grid.to(torch.float32),
                        torch.zeros(gshape, dtype=torch.float32, device=dev))
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    rres = df_iterative_refinement(
                        gop, None, solve32, rtol=cfg.rtol, b_df=b_df,
                        return_host=False,
                    )
                    fence(rres.x[0])
                    elapsed = time.perf_counter() - t0
            else:
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    kres = cg_solve(gop.mv, b_grid, maxiter=cfg.maxiter,
                                    rtol=cfg.rtol, precond=M)
                    fence(kres.x)
                    elapsed = time.perf_counter() - t0
                x_flat = kres.x.reshape(-1)
        else:
            raise SystemExit(
                "MGPCG supports backends 'stacked', 'sharded', and 'tiled'"
            )

        if want_refine:
            # df-refined path: report the DF true-residual norm (an f32
            # recombination of x would floor the reported residual at
            # ~1e-7, the very limit refinement exists to beat) and the
            # error of the f64 recombination of the df pair
            import numpy as np

            from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import (
                df64,
            )

            x64 = (np.asarray(rres.x, np.float64).reshape(-1)
                   if not isinstance(rres.x, tuple)
                   else df64.df_to_f64(rres.x).reshape(-1))
            err = float(np.linalg.norm(x64 - 1.0))
            result = dict(
                sweeps=0, cycles=int(rres.passes), inner_iters=0,
                converged=bool(rres.converged),
                rnorm=float(rres.rnorm), rnorm0=float(rres.rnorm0),
                refine_passes=int(rres.passes),
                residual_history=[float(h) for h in rres.rel_history],
                alg=cfg.alg, backend=cfg.backend, dim=cfg.dim,
                grid=grid_label,
                elapsed_s=round(elapsed, 4),
                final_true_rnorm=float(rres.rnorm),
                rel_rnorm=(float(rres.rnorm / rres.rnorm0)
                           if rres.rnorm0 else 0.0),
                error_vs_ones=err,
                device=str(dev),
            )
            return result, pt
        result = _krylov_record(kres)
    else:
        if cfg.backend == "host_async":
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.host_async import (
                host_async_solve,
            )

            if cfg.schedule != "async":
                raise SystemExit(
                    "host_async backend runs the async algorithms (AM/AMAM_*)"
                )
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                hres = host_async_solve(
                    op, b, rtol=cfg.rtol, atol=cfg.atol,
                    maxiter=cfg.maxiter,
                    min_convergence_count=cfg.min_convergence_count,
                    inner=cfg.inner_config(),
                    minimization=cfg.minimization, s=cfg.s,
                    intra=cfg.intra,
                )
                elapsed = time.perf_counter() - t0
            x_flat = hres.x.reshape(-1)
            result = dict(
                sweeps=sum(hres.sweeps_per_block), cycles=0,
                inner_iters=0, converged=bool(hres.converged),
                rnorm=hres.rnorm, rnorm0=hres.rnorm0,
                sweeps_per_block=hres.sweeps_per_block,
                certified=bool(hres.certified),
                tail_sweeps=int(hres.tail_rounds),
            )
            r = b.reshape(-1) - op.global_mv(x_flat)
            final_norm = float(torch.linalg.vector_norm(r))
            err = float(torch.linalg.vector_norm(x_flat - 1.0))
            result.update(
                alg=cfg.alg, backend=cfg.backend, dim=cfg.dim,
                grid=grid_label,
                elapsed_s=round(elapsed, 4),
                final_true_rnorm=final_norm,
                rel_rnorm=final_norm / result["rnorm0"],
                error_vs_ones=err,
                device=str(dev),
            )
            return result, pt
        staleness = cfg.staleness if cfg.schedule == "async" else 1
        if cfg.backend == "tiled":
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
                tiled_multisplit_solve,
                tiled_multisplit_solve_3d,
            )

            tmesh = make_tiled_mesh()
            dims = ((cfg.m, cfg.n) if cfg.dim == 2
                    else (cfg.m, cfg.n, cfg.nz))
            tiled = (tiled_multisplit_solve if cfg.dim == 2
                     else tiled_multisplit_solve_3d)

            def solve():
                return tiled(
                    tmesh, *dims, b.reshape(dims),
                    schedule=cfg.schedule, staleness=staleness,
                    minimization=cfg.minimization, s=cfg.s,
                    record_history=record_history,
                    basis_collection=cfg.basis_collection, **kw,
                )
        elif cfg.backend == "sharded":
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
                sharded_multisplit_solve,
            )

            mesh = make_mesh()
            opcfg = sharded_opcfg()
            b_grid = b.reshape(opcfg.global_shape)

            def solve():
                return sharded_multisplit_solve(
                    mesh, opcfg, b_grid,
                    schedule=cfg.schedule, staleness=staleness,
                    minimization=cfg.minimization, s=cfg.s,
                    record_history=record_history,
                    basis_collection=cfg.basis_collection, **kw,
                )
        elif stage_timers:
            from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.staged import (
                staged_multisplit_solve,
            )

            def solve():
                return staged_multisplit_solve(
                    op, b,
                    schedule=cfg.schedule, staleness=staleness,
                    minimization=cfg.minimization, s=cfg.s, timer=pt, **kw,
                )
        else:
            def solve():
                return ms.multisplit_solve(
                    op, b,
                    schedule=cfg.schedule, staleness=staleness,
                    minimization=cfg.minimization, s=cfg.s,
                    record_history=record_history,
                    basis_collection=cfg.basis_collection, **kw,
                )

        with trace(profile_dir), pt.phase("I_Solver"):
            t0 = time.perf_counter()
            res = solve()
            fence(res.x)
            elapsed = time.perf_counter() - t0
        x_flat = res.x.reshape(-1)
        result = dict(sweeps=int(res.sweeps), cycles=int(res.cycles),
                      inner_iters=int(res.inner_iters),
                      converged=bool(res.converged),
                      rnorm=float(res.rnorm), rnorm0=float(res.rnorm0))
        if getattr(res, "certified", None) is not None:
            # async certification tail: the bound verified on the true
            # (staleness-free) coupling
            result["certified"] = bool(res.certified)
            result["tail_sweeps"] = int(res.tail_sweeps)
        if res.history is not None:
            # per-cycle residual norms (the reference prints one per
            # iteration, asynchronous-multisplitting_prime.c:345)
            result["residual_history"] = [
                float(h) for h in res.history[:int(res.cycles)]]

    with pt.phase("Last"):
        r = b.reshape(-1) - op.global_mv(x_flat)
        final_norm = float(torch.linalg.vector_norm(r))
        err = float(torch.linalg.vector_norm(x_flat - 1.0))
        fence(r)

    result.update(
        alg=cfg.alg, backend=cfg.backend, dim=cfg.dim,
        grid=grid_label,
        elapsed_s=round(elapsed, 4),
        final_true_rnorm=final_norm,
        rel_rnorm=final_norm / result["rnorm0"] if result["rnorm0"] else 0.0,
        error_vs_ones=err,
        device=str(dev),
    )
    return result, pt


def _write_flame(path: str, items, title: str) -> None:
    """The stage timers as a ``.txt`` of folded stacks, an ``.xml``
    nested-timer report (with ``performance_xml2html.xsl`` beside it) or
    an HTML flamegraph."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.report import (
        folded,
        render_flamegraph,
        render_xml,
        render_xml_stylesheet,
    )

    with open(path, "w") as f:
        if path.endswith(".txt"):
            f.write(folded(items))
        elif path.endswith(".xml"):
            # -log_view ::ascii_xml analog: nested-timer XML and the
            # companion XSL next to it (performance_xml2html parity)
            f.write(render_xml(items, title=title))
            xsl = os.path.join(os.path.dirname(os.path.abspath(path)),
                               "performance_xml2html.xsl")
            with open(xsl, "w") as g:
                g.write(render_xml_stylesheet())
        else:
            f.write(render_flamegraph(items, title=title))
    print(f"wrote {path}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.devices_per_process != DEVICES_PER_PROCESS:
        raise SystemExit(
            "--devices-per-process has no twin in the port: JAX gives each "
            "multihost process virtual CPU devices, here each rank holds its "
            "share of the mesh's shards on one device (the mesh's local "
            "extents); leave it at its default"
        )
    if args.net_async:
        result = run_net_async(args)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"Algorithm          : {result['alg']} "
                  f"({result['backend']})")
            print(f"Grid               : {result['grid']}")
            print(f"Sweeps per block   : {result['sweeps_per_block']}")
            print(f"Final residual     : {result['rnorm']:.6e} "
                  f"(rel {result['rel_rnorm']:.3e})")
            print(f"Converged          : {result['converged']}")
            print(f"Certified          : {result['certified']}")
            print(f"Elapsed            : {result['elapsed_s']:.3f} s")
            print(f"Error vs u=1       : {result['error_vs_ones']:.6e}")
        return 0 if result["converged"] else 2
    if args.multihost:
        result = run_multihost(args)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"Algorithm          : {result['alg']} ({result['backend']})")
            print(f"Processes/shards   : {result['num_processes']} x "
                  f"{result['local_shards']} of mesh {result['mesh']}")
            print(f"Initial residual   : {result['rnorm0']:.6e}")
            print(f"Final residual     : {result['rnorm']:.6e}")
            print(f"Sweeps / cycles    : {result['sweeps']} / {result['cycles']}")
            print(f"Converged          : {result['converged']}")
            print(f"Elapsed            : {result['elapsed_s']:.4f} s")
            print(f"Error vs u=1       : {result['err_vs_ones']:.6e}")
        return 0 if result["converged"] else 2
    cfg = config_from_args(args)
    if args.show_config:
        print(json.dumps(
            {"resolved_config": dataclasses.asdict(cfg)}, default=str
        ))
    stage_timers = args.stage_timers or bool(args.flame)
    result, pt = run(
        cfg, profile_dir=args.profile_dir,
        stage_timers=stage_timers,
        record_history=args.record_history or stage_timers,
    )

    if args.flame:
        _write_flame(args.flame, pt.items(),
                     f"{cfg.alg} {result.get('grid', '')} stage timers")

    if args.json:
        print(json.dumps(result))
    else:
        print(f"Algorithm          : {result['alg']} ({result['backend']})")
        print(f"Grid               : {result['grid']} ({result['dim']}D)")
        print(f"Initial residual   : {result['rnorm0']:.6e}")
        print(f"Final true residual: {result['final_true_rnorm']:.6e} "
              f"(rel {result['rel_rnorm']:.3e})")
        print(f"Sweeps / cycles    : {result['sweeps']} / {result['cycles']}")
        print(f"Inner iterations   : {result['inner_iters']}")
        print(f"Converged          : {result['converged']}")
        print(f"Elapsed            : {result['elapsed_s']:.4f} s")
        print(f"Error vs u=1       : {result['error_vs_ones']:.6e}")
        if "residual_history" in result:
            print("Residual norms     :")
            for i, h in enumerate(result["residual_history"]):
                print(f"  cycle {i:>4d}: {h:.6e}")
        pt.report()
    return 0 if result["converged"] else 2


if __name__ == "__main__":
    sys.exit(main())
