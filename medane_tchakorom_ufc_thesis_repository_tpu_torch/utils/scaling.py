"""Weak-scaling harness: fixed load a shard, growing shard count (port of
the JAX package's ``utils/scaling.py``).

The same sharded program runs on ``(2, nd // 2)`` meshes of the port's
``'local'`` transport (every shard in this process, on one device): the
rows a shard are fixed, the mesh grows, and a fixed number of
multisplitting sweeps is timed.  Efficiency(N) = T(N_min) / T(N) for
fixed work a shard (ideal 1.0).  On one device the shards share it, so
the wall-clock efficiency measures the cost of the layout, not a
multi-device speed-up; ``run_structural`` gives the structural argument
instead, from the mesh's collective tally.

Usage::

    python -m medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.scaling \
        --rows-per-device 128 --n 512 --sweeps 20 --devices 2,4,8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import (
    fence,
)


def _check_even(nd: int) -> None:
    if nd % 2:
        raise ValueError("device counts must be even (2 Jacobi blocks)")


def _rhs2d(m: int, n: int, device) -> torch.Tensor:
    """``b = A 1`` of the 2D operator, from the exact host matvec, in f32."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
        stencil2d_mv_np,
    )

    return torch.as_tensor(stencil2d_mv_np(m, n)(np.ones(m * n)).reshape(m, n),
                           dtype=torch.float32, device=device)


def run_weak_scaling(
    rows_per_device: int = 128,
    n: int = 512,
    sweeps: int = 20,
    device_counts: List[int] = (2, 4, 8),
    inner_maxiter: int = 20,
    alg: str = "SM",
    device=None,
) -> List[Dict]:
    """Time the SM sweeps (or, ``alg='MGPCG'``, the sharded north-star to
    1e-8 on a 3D grid) at each mesh size, on ``device`` (None: the current
    CUDA device); one untimed run first."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import (
        resolve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
        InnerConfig,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
        ShardedPoisson2D,
        ShardedPoisson3D,
        make_mesh,
        sharded_df_northstar,
        sharded_multisplit_solve,
    )

    dev = resolve(device)
    records = []
    for nd in device_counts:
        _check_even(nd)
        mesh = make_mesh(nblocks=2, intra=nd // 2, device=dev)
        m = rows_per_device * nd

        if alg.upper() == "MGPCG":
            # weak-scale the north-star itself: fixed x-planes a shard on
            # a 3D grid, MG-PCG + df refinement to 1e-8 (MG iteration
            # counts are grid-independent)
            cfg3 = ShardedPoisson3D(m, n, n)

            res = sharded_df_northstar(mesh, cfg3, rtol=1e-8)  # warm-up
            fence(res.x[0])
            t0 = time.perf_counter()
            res = sharded_df_northstar(mesh, cfg3, rtol=1e-8)
            fence(res.x[0])
            dt = time.perf_counter() - t0
            rec = {
                "devices": nd,
                "grid": f"{m}x{n}x{n}",
                "refine_passes": int(res.passes),
                "rel_residual": f"{res.rnorm / res.rnorm0:.2e}",
                "converged": bool(res.converged),
                "wall_s": round(dt, 4),
            }
            records.append(rec)
            print(f"[scaling] {json.dumps(rec)}")
            continue

        cfg = ShardedPoisson2D(m, n)
        b = _rhs2d(m, n, dev)

        def solve():
            return sharded_multisplit_solve(
                mesh, cfg, b, rtol=1e-30, maxiter=sweeps,
                inner=InnerConfig(maxiter=inner_maxiter, rtol=1e-10),
            )

        res = solve()          # warm-up (kernel builds on the card)
        fence(res.x)
        t0 = time.perf_counter()
        res = solve()
        fence(res.x)
        dt = time.perf_counter() - t0
        # each inner GMRES iteration applies A_ii once (plus the
        # orthogonalization): count SpMV-equivalent work for a throughput
        spmv_equiv = int(res.inner_iters) * cfg.nnz
        rec = {
            "devices": nd,
            "grid": f"{m}x{n}",
            "sweeps": int(res.sweeps),
            "inner_iters": int(res.inner_iters),
            "wall_s": round(dt, 4),
            "spmv_equiv_nnz_per_s": round(spmv_equiv / dt / 1e9, 3),
        }
        records.append(rec)
        print(f"[scaling] {json.dumps(rec)}")

    if records:
        t_base = records[0]["wall_s"]
        for r in records:
            r["weak_efficiency"] = round(t_base / r["wall_s"], 3)
        print(f"[scaling] efficiencies: "
              f"{[(r['devices'], r['weak_efficiency']) for r in records]}")
    return records


def run_structural(
    rows_per_device: int = 128,
    n: int = 512,
    device_counts: List[int] = (2, 4, 8),
    inner_maxiter: int = 20,
    alg: str = "SM",
    device=None,
) -> List[Dict]:
    """STRUCTURAL weak-scaling evidence (no wall clock): run the same
    sharded program at each mesh size with fixed load a shard and tally
    its collectives on the mesh (``Mesh.count_collectives``, per-shard
    bytes).  Weak scaling holds structurally when bytes a shard stay flat
    as the mesh grows.

    The JAX package reads these numbers from the compiled SPMD HLO, where
    each collective appears once per program and a loop body once; the
    tally counts calls as they run.  So each mesh size runs a fixed
    amount of work: SM with ``rtol=1e-30`` and 20 sweeps (as JAX's), and
    for MGPCG one PCG iteration with its W-cycle (3D, ``maxiter=1``,
    ``rtol=1e-30``).  A mesh of one shard a block (2 shards) has no halos
    inside a block, which every inner matvec of a larger mesh exchanges,
    so its bytes a shard lie below the larger meshes'; from there halo
    planes and scalar reductions stay fixed a shard, and only the gathered
    coarsest grid of the cycle (one ``all-gather`` a coarse visit) grows
    with the global grid.
    """
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import (
        resolve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
        InnerConfig,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
        ShardedPoisson2D,
        ShardedPoisson3D,
        make_mesh,
        sharded_mgpcg_solve,
        sharded_multisplit_solve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import collstats

    dev = resolve(device)
    records = []
    for nd in device_counts:
        _check_even(nd)
        mesh = make_mesh(nblocks=2, intra=nd // 2, device=dev)
        m = rows_per_device * nd

        if alg.upper() == "MGPCG":
            cfg3 = ShardedPoisson3D(m, n, n)
            b3 = stencil3d.stencil3d_apply(
                torch.ones(m, n, n, device=dev), kind="mv", diag=cfg3.diag,
                off=cfg3.off)
            with mesh.count_collectives() as stats:
                sharded_mgpcg_solve(mesh, cfg3, b3, rtol=1e-30, maxiter=1)
            grid = f"{m}x{n}x{n}"
        else:
            cfg = ShardedPoisson2D(m, n)
            b = _rhs2d(m, n, dev)
            with mesh.count_collectives() as stats:
                sharded_multisplit_solve(
                    mesh, cfg, b, rtol=1e-30, maxiter=20,
                    inner=InnerConfig(maxiter=inner_maxiter, rtol=1e-10))
            grid = f"{m}x{n}"

        rec = {
            "devices": nd,
            "grid": grid,
            "collectives": stats,
            "total_count": collstats.total_collective_count(stats),
            "bytes_per_device": collstats.total_collective_bytes(stats),
        }
        records.append(rec)
        print(f"[scaling] {json.dumps(rec)}")

    if len(records) >= 2:
        base = records[0]["bytes_per_device"]
        for r in records:
            r["bytes_vs_smallest_mesh"] = round(
                r["bytes_per_device"] / max(base, 1), 3
            )
        print("[scaling] bytes/device vs smallest mesh: "
              f"{[(r['devices'], r['bytes_vs_smallest_mesh']) for r in records]}")
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling")
    p.add_argument("--rows-per-device", type=int, default=128)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--sweeps", type=int, default=20)
    p.add_argument("--devices", default="2,4,8")
    p.add_argument("--alg", default="SM",
                   help="SM (fixed sweeps) | MGPCG (north-star to 1e-8)")
    p.add_argument("--structural", action="store_true",
                   help="no wall clock: tally the collectives on the mesh "
                        "at each mesh size")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the meshes live (default: the card)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    counts = [int(x) for x in args.devices.split(",")]
    if args.structural:
        recs = run_structural(
            args.rows_per_device, args.n, counts, alg=args.alg,
            device=args.device,
        )
    else:
        recs = run_weak_scaling(
            args.rows_per_device, args.n, args.sweeps, counts,
            alg=args.alg, device=args.device,
        )
    if args.out:
        with open(args.out, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
