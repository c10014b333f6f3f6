"""Bulk sweeps: grids of configurations, timeouts, JSONL logs (port of the
JAX package's ``utils/bulk.py``).

The reference's ``running_bulk_test_local`` / ``running_bulk_test_g5k``
(SURVEY.md §2.6): arrays of (algorithm, mesh, tolerance, inner budget)
combinations run under a wall-clock timeout, results archived for later
analysis.  Each run is a subprocess of the port's CLI, so a hang or an
out-of-memory cannot take the sweep down (the reference's
``timeout -k``-wrapped mpiexec lines).  The runs build on the card; pass
``--device cpu`` among the CLI arguments for the host.

Usage::

    python -m medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.bulk \
        --out runs.jsonl --timeout 600 \
        --algs SM,SMSM_GLOBAL --meshes 128,256 --rtols 1e-3,1e-5
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Optional


def run_one(cfg_args: List[str], timeout_s: float,
            env: Optional[Dict[str, str]] = None) -> Dict:
    """Run one CLI configuration in a subprocess; returns its result
    record (the CLI's JSON line) with ``wall_s`` and ``returncode``, or
    an ``error`` record on a timeout or unparseable output.

    ``env`` entries overlay the inherited environment; a value of
    ``None`` removes the variable.
    """
    cmd = [
        sys.executable, "-m",
        "medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.cli",
        "--json", *cfg_args,
    ]
    full_env = None
    if env:
        full_env = dict(os.environ)
        for k, v in env.items():
            if v is None:
                full_env.pop(k, None)
            else:
                full_env[k] = v
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=timeout_s,
            env=full_env,
        )
        wall = time.perf_counter() - t0
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            rec = {"error": "unparseable output",
                   "stdout": proc.stdout[-500:], "stderr": proc.stderr[-500:]}
        rec.update(wall_s=round(wall, 3), returncode=proc.returncode)
    except subprocess.TimeoutExpired:
        rec = {"error": "timeout", "wall_s": timeout_s,
               "returncode": -1, "args": cfg_args}
    return rec


def sweep(
    algs: Iterable[str],
    meshes: Iterable[int],
    rtols: Iterable[float],
    *,
    extra_args: List[str] = (),
    timeout_s: float = 600.0,
    out_path: str = "bulk_runs.jsonl",
    dim: int = 2,
) -> List[Dict]:
    records = []
    with open(out_path, "a") as f:
        for alg, mesh, rtol in itertools.product(algs, meshes, rtols):
            args = ["--alg", alg, "--m", str(mesh), "--n", str(mesh),
                    "--dim", str(dim), "--rtol", str(rtol), *extra_args]
            if dim == 3:
                args += ["--nz", str(mesh)]
            rec = run_one(args, timeout_s)
            rec.update(alg=alg, mesh=mesh, rtol=rtol, ts=time.time())
            records.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            status = rec.get("error") or (
                "ok" if rec.get("converged") else "no-conv"
            )
            print(f"[bulk] {alg} mesh={mesh} rtol={rtol}: {status} "
                  f"({rec.get('wall_s', '?')}s)")
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bulk")
    p.add_argument("--algs", default="SM,SMSM_GLOBAL")
    p.add_argument("--meshes", default="128,256")
    p.add_argument("--rtols", default="1e-3")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default="bulk_runs.jsonl")
    p.add_argument("rest", nargs="*", help="extra CLI args passed through")
    args = p.parse_args(argv)
    sweep(
        args.algs.split(","),
        [int(x) for x in args.meshes.split(",")],
        [float(x) for x in args.rtols.split(",")],
        extra_args=args.rest,
        timeout_s=args.timeout,
        out_path=args.out,
        dim=args.dim,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
