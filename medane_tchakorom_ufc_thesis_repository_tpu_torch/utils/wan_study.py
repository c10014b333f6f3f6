"""The async-versus-sync WAN study, the thesis's core experimental claim
(port of the JAX package's ``utils/wan_study.py``).

The reference stresses its async variants against the sync ones on a
``tc qdisc``-shaped 50 mbit / 100 ms bridge
(``running_bulk_test_local:322-330``): asynchronous iterations should
degrade far less with link latency, since compute never waits for the
exchange.  This harness repeats that experiment over the port's TCP
deployment path: one OS process per Jacobi block
(``models.net_async.launch_net_async``), WAN emulation in the transport
(``models.net.WanConfig``: a delay queue in the Python router and in the
native epoll router), sync (lockstep acknowledged rounds = SM/SMSM)
against async (latest-wins + Alg-5.15 = AM/AMAM) on the same sockets.
A cell that ends uncertified is reported as ``UNCERT``, never dropped.

Run:  python -m medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.wan_study
      [--m 48] [--latencies 0,25,100] [--rtol 1e-4] [--json out.json]
      [--device cpu]

Output: one row per (algorithm, latency): wall time (max over ranks),
sweeps, converged, certified, merged true relative residual.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch


def _merged_rel(results: List[dict], m: int, n: int) -> float:
    """The merged iterate's true relative residual, on the host in f64
    (nblocks inferred from the result count)."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops

    op = blockops.block_poisson2d(m, n, nblocks=len(results))
    b = blockops.rhs_ones(op, torch.float64, "cpu")
    by_rank = sorted(results, key=lambda r: r["rank"])
    x = torch.from_numpy(np.concatenate(
        [np.asarray(r["x_block"], np.float64) for r in by_rank]))
    r_ = (b.reshape(-1) - op.global_mv(x)).numpy()
    return float(np.linalg.norm(r_) / by_rank[0]["rnorm0"])


def run_study(
    *,
    m: int = 48,
    n: Optional[int] = None,
    nblocks: int = 2,
    latencies_ms=(0.0, 25.0, 100.0),
    rtol: float = 1e-4,
    s: int = 4,
    inner_maxiter: int = 20,
    maxiter: int = 6000,
    bw_mbit: float = 50.0,
    transport: str = "auto",
    timeout_s: float = 600.0,
    device: str = "cuda",
) -> List[dict]:
    """Run the sweep of ``nblocks`` processes on ``device`` ('cuda': card
    0, shared; or 'cpu'); returns one record per cell."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.net_async import (
        launch_net_async,
    )

    n = m if n is None else n
    algs = [
        ("SM", dict(schedule="sync", minimization=None)),
        ("AM", dict(schedule="async", minimization=None)),
        ("SMSM_GLOBAL", dict(schedule="sync", minimization="global")),
        ("AMAM_GLOBAL", dict(schedule="async", minimization="global")),
    ]
    rows = []
    for lat in latencies_ms:
        for name, kw in algs:
            t0 = time.perf_counter()
            res = launch_net_async(
                nblocks=nblocks, m=m, n=n, rtol=rtol, maxiter=maxiter,
                inner_maxiter=inner_maxiter, s=s,
                transport=transport, timeout_s=timeout_s,
                wan_latency_ms=lat, wan_bw_mbit=bw_mbit, device=device,
                **kw,
            )
            wall = time.perf_counter() - t0
            rows.append({
                "alg": name,
                "nblocks": nblocks,
                "latency_ms": lat,
                "bw_mbit": bw_mbit,
                "wall_s": round(max(r["elapsed_s"] for r in res), 3),
                "launch_wall_s": round(wall, 3),
                "sweeps": max(r["sweeps"] for r in res),
                "tail_rounds": max(r.get("tail_rounds", 0)
                                   for r in res),
                "converged": all(r["converged"] for r in res),
                "certified": all(bool(r.get("certified"))
                                 for r in res),
                "rel_residual": _merged_rel(res, m, n),
            })
            print(json.dumps(rows[-1]), flush=True)
    return rows


def as_markdown(rows: List[dict]) -> str:
    lats = sorted({r["latency_ms"] for r in rows})
    algs = []
    for r in rows:
        if r["alg"] not in algs:
            algs.append(r["alg"])
    head = ("| alg | " + " | ".join(f"{int(latency)} ms wall (sweeps)"
                                    for latency in lats) + " |")
    sep = "|---" * (len(lats) + 1) + "|"
    lines = [head, sep]
    for a in algs:
        cells = []
        for latency in lats:
            rr = [r for r in rows
                  if r["alg"] == a and r["latency_ms"] == latency]
            if rr:
                r = rr[0]
                mark = "" if r["certified"] else " UNCERT"
                tail = (f"+{r['tail_rounds']}t"
                        if r.get("tail_rounds") else "")
                cells.append(
                    f"{r['wall_s']} s ({r['sweeps']}{tail}, "
                    f"rel {r['rel_residual']:.1e}){mark}")
            else:
                cells.append("—")
        lines.append(f"| {a} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wan_study")
    p.add_argument("--m", type=int, default=48)
    p.add_argument("--nblocks", type=int, default=2)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--latencies", default="0,25,100",
                   help="comma-separated one-way latencies in ms")
    p.add_argument("--rtol", type=float, default=1e-4)
    p.add_argument("--s", type=int, default=4)
    p.add_argument("--inner-maxiter", type=int, default=20)
    p.add_argument("--bw-mbit", type=float, default=50.0)
    p.add_argument("--transport", default="auto")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the ranks run (default: the card)")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    rows = run_study(
        m=args.m, n=args.n, nblocks=args.nblocks,
        latencies_ms=[float(x) for x in args.latencies.split(",")],
        rtol=args.rtol, s=args.s, inner_maxiter=args.inner_maxiter,
        bw_mbit=args.bw_mbit, transport=args.transport, device=args.device,
    )
    print()
    print(as_markdown(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
