"""The port's asynchronous multisplitting (``am``: staleness 2, GMRES(30)
inner with maxit 20 and rtol 1e-3, the reference's default experiment)
held against the benchmark's plain reference of the same schedule
(``portbench/reference/multisplit.py``), on the CPU.

The reference shares no code with the port: its GMRES orthogonalises by
modified Gram-Schmidt and solves the Hessenberg least squares by
``torch.linalg.lstsq``, where the port runs two classical passes and
Givens rotations, so the two differ by rounding in every sweep.  The
counts (sweeps, tail sweeps, inner iterations) must still agree exactly:
every decision of the schedule is a threshold that the rounding does not
reach.  The answers cannot agree to rounding: a GMRES-inner sweep map
amplifies a one-ulp difference by about 1e9 over a solve (``PERF.md``
section 6; the JAX run against itself with ``b`` moved by 1e-16 moves x
by 6e-7 at 32^2 under AM).  So they are held to 1e-4 of the largest
entry, as the port is held to the JAX package (the largest difference
measured here is 5e-6).

Also here: a fault planted in the reference's schedule changes its count,
the certification span is recorded once per asynchronous solve, and the
benchmark's cell runs at a tiny size through its harness.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import profiling
from portbench.reference import multisplit as ref
from portbench.reference.stencil import poisson_apply, relative_residual
# the benchmark tests' copy of the benchmark with a tiny twin of each cell
# (p2d_1024.am.tiny: 32^2)
from portbench.conftest import add_tiny_grids
from portbench.tests import conftest as bench_tests
from portbench.tests.conftest import tiny_root  # noqa: F401

add_tiny_grids(bench_tests)

# one intra-op thread a process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-3
INNER = {"restart": 30, "maxiter": 20, "rtol": 1e-3}
# the relative agreement of the two answers at convergence (see above)
X_RTOL = 1e-4


def _b(n):
    """``b = A 1`` on the ``n x n`` grid, in f64 (the golden counts')."""
    return poisson_apply(torch.ones((n, n), dtype=torch.float64), 4.0, -1.0)


def _port(b, dtype, **kw):
    n = b.shape[0]
    op = port.block_poisson2d(n, n, nblocks=2)
    return port.am(op, b.reshape(2, -1).to(dtype), staleness=2, rtol=RTOL,
                   maxiter=10000, min_convergence_count=4,
                   inner=port.InnerConfig(**INNER), **kw)


def _ref(b, dtype):
    return ref.am(b, 2, staleness=2, rtol=RTOL, maxiter=10000,
                  min_convergence_count=4, inner=INNER, dtype=dtype)


@pytest.mark.parametrize("n,dtype,sweeps", [
    (32, torch.float64, 88),     # the golden count
    (64, torch.float64, None),
    (32, torch.float32, 88),
], ids=["32-f64", "64-f64", "32-f32"])
def test_port_against_the_reference(n, dtype, sweeps):
    b = _b(n)
    got, want = _port(b, dtype), _ref(b, dtype)
    assert got.certified and got.converged and want.certified
    assert got.sweeps == want.sweeps
    assert got.tail_sweeps == want.tail_sweeps
    assert int(got.inner_iters) == want.inner_iters
    if sweeps is not None:
        assert got.sweeps == sweeps
    x_port = got.x.reshape(n, n).to(torch.float64)
    x_ref = want.x.to(torch.float64)
    assert relative_residual(b, x_port, 4.0, -1.0) <= RTOL
    assert relative_residual(b, x_ref, 4.0, -1.0) <= RTOL
    scale = float(x_ref.abs().max())
    assert float((x_port - x_ref).abs().max()) <= X_RTOL * scale


def _no_gate(count, under, all_published):
    return count + 1 if under else 0


@pytest.mark.parametrize("fault", ["gate_removed", "staleness_1"])
def test_a_planted_fault_changes_the_count(monkeypatch, fault):
    """The comparison is tight: the reference with the pseudo-period gate
    taken out, or publishing every sweep, stops at another sweep."""
    b = _b(32)
    got = _port(b, torch.float64)
    if fault == "gate_removed":
        monkeypatch.setattr(ref, "gate", _no_gate)
        want = _ref(b, torch.float64)
    else:
        want = ref.am(b, 2, staleness=1, rtol=RTOL, inner=INNER)
    assert want.certified
    assert want.sweeps != got.sweeps


def _solve(entry):
    op = port.block_poisson2d(32, 32, nblocks=2)
    b = op.full_mv(torch.ones((2, op.block_size), dtype=torch.float64))
    if entry == "am":
        return port.am(op, b, staleness=2, rtol=RTOL)
    if entry == "sm":
        return port.sm(op, b, rtol=RTOL)
    return port.smsm(op, b, scope="global", s=4, rtol=RTOL)


@pytest.mark.parametrize("entry", ["am", "sm", "smsm"])
def test_certify_span_once_per_async_solve(entry):
    profiling.reset()
    try:
        off = _solve(entry)
        with profiling.recording():
            on = _solve(entry)
        got = profiling.totals()
    finally:
        profiling.reset()
    calls = got.get("multisplit.Certify", (0, 0.0, 0.0))[0]
    assert calls == (1 if entry == "am" else 0)
    assert torch.equal(off.x, on.x)
    for field in ("sweeps", "cycles", "tail_sweeps", "certified", "syncs",
                  "converged"):
        assert getattr(off, field) == getattr(on, field), field
    assert torch.equal(off.inner_iters, on.inner_iters)


def test_the_reference_imports_neither_jax_nor_the_port():
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import portbench.reference.multisplit\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in "
            "list(sys.modules)})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    jax_pkg = "medane_tchakorom_ufc_thesis_repository_tpu"
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", jax_pkg, jax_pkg + "_torch"}


CELL = "p2d_1024.am"


@pytest.mark.parametrize("trace_on", [False, True], ids=["untraced", "traced"])
def test_the_cell_at_a_tiny_size(tiny_root, trace_on):
    from portbench import harness

    out = harness.execute(tiny_root, f"{CELL}.tiny", 2**31 + 77, 0.3,
                          trace_on, "cpu", 0.0)
    line = out["line"]
    assert out["ok"] and line["correct"] is True and line["failed"] == 0
    assert line["compared"]["unconverged"] == {"value": 0, "limit": 0}
    metrics = line["metrics"]
    if trace_on:
        # no card: the counts alone, no device figure and no span's
        assert set(metrics) == {"multisplit.sweeps", "multisplit.inner_iters",
                                "multisplit.tail_sweeps"}
        assert metrics["multisplit.tail_sweeps"]["unit"] == "sweeps/solve"
        assert metrics["multisplit.sweeps"]["value"] > \
            metrics["multisplit.tail_sweeps"]["value"] >= 0
    else:
        assert {"solve_s.host_driven", "setup_s"} <= set(metrics)
