"""Multi-process fan-out on one host (port of part of the JAX package's
``utils/multihost.py``): the ``mpiexec`` analog that
``models.net_async.launch_net_async`` starts its ranks with.

Only the launcher's helpers are ported here: ``free_port``,
``scrubbed_env``, ``repo_root`` and ``run_ranks``.  The JAX module's
``jax.distributed`` worker and its mesh wait for the port's distributed
backend.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import time
from typing import List, Sequence


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
