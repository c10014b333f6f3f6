"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  Prints one JSON line on standard output; the numbers compared
with the reference are the last lines on standard error.  Exits 2 without
a result when the cards are missing, 3 when the process has loaded JAX or
the JAX package.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from ``torch.profiler``.
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, registry

    chips = int(registry.workload(registry.load(ROOT), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"{args.workload} needs {chips} CUDA card(s), found {have}: "
                    f"no result")
        return 2
    out = harness.execute(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded {found}: the port's benchmark may load "
                    f"neither JAX nor the JAX package; no result")
        return 3
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
