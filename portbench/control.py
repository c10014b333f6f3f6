"""The control of the check: the port's own answer held in the precision
below the one the configuration states (double-float -> f32 for the
north-star entries, f32 -> bf16 for multisplitting), judged by the same
reference as the answer itself.  A check that passes the control cannot
tell a lower-precision program from a sound one.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

prints, for each pool seed (the cell's own pool is ``pool_seed`` of its
traffic mix) and each of the first ``--solves`` members of that pool, the
relative residual of the answer and of its control; the benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root, name: str, seeds, solves: int, device) -> list:
    """``[{"seed", "k", "program", "control", "converged"}, ...]``, one
    row for member ``k`` of the pool drawn from pool seed ``seed``."""
    import torch

    from portbench import registry, rhs
    from portbench.reference.stencil import relative_residual

    device = torch.device(device)
    bench = registry.load(root)
    cell = registry.workload(bench, name)
    config = registry.config(root, bench, cell["config"])
    mix = registry.traffic(root, cell["traffic"])
    entry = registry.entry(root, mix["entry"])
    grid = [int(n) for n in config["grid"]]
    diag, off = float(config["stencil"]["diag"]), float(config["stencil"]["off"])
    state = entry.build(config, mix["params"], device)
    out = []
    try:
        for seed in seeds:
            for k in range(solves):
                spec = dict(mix["rhs"], pool_seed=seed)
                b64 = rhs.make(grid, spec, config["stencil"], k, device)
                inp = entry.inputs(config, b64)
                del b64
                res = entry.solve(state, inp)
                ans, ok = entry.answer(res), entry.converged(res)
                del res
                b = entry.given(inp).reshape(grid)
                del inp
                row = {"seed": seed, "k": k, "converged": ok}
                for key, a in (("program", ans), ("control", entry.control(ans))):
                    x = entry.answer_f64(config, a).reshape(grid)
                    row[key] = relative_residual(b, x, diag, off)
                    del x
                del ans, b
                gc.collect()
                out.append(row)
    finally:
        entry.close(state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for row in readings(ROOT, args.workload, args.seeds, args.solves, "cuda:0"):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
