"""The port's tooling against the JAX package's, on the CPU: checkpoints
(``utils/checkpoint.py``; one file format, each package resumes the
other's), the reports (``utils/report.py``, byte-equal strings) and the
CLI's ``--flame``, the bulk runner (``utils/bulk.py``), the scaling
harness (``utils/scaling.py``) with the mesh's collective tally
(``parallel/mesh.py``, ``utils/collstats.py``), the WAN study
(``utils/wan_study.py``) and the CLI's process launches (``--multihost``,
``--net-async``).
"""

import contextlib
import io
import json
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    blockops as jbo,
    multisplitting as jms,
)
from medane_tchakorom_ufc_thesis_repository_tpu.utils import (
    checkpoint as jck,
    report as jrep,
    wan_study as jwan,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    blockops,
    multisplitting as tms,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    ShardedPoisson2D,
    make_mesh,
    sharded_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import (
    bulk,
    checkpoint as tck,
    cli as tcli,
    collstats,
    report as trep,
    scaling as tscaling,
    wan_study as twan,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = "cpu"


# -- checkpoints ----------------------------------------------------------------

def _port_problem():
    op = blockops.block_poisson2d(16, 16)
    return op, blockops.rhs_ones(op, torch.float64, CPU)


def test_roundtrip_and_resume(tmp_path):
    """JAX's ``TestCheckpoint.test_roundtrip_and_resume`` on the port."""
    op, b = _port_problem()
    partial = tms.sm(op, b, rtol=1e-14, maxiter=10)   # stop mid-solve
    p = str(tmp_path / "ckpt.npz")
    tck.save_state(p, partial.x, sweeps=int(partial.sweeps))
    x0, meta = tck.load_state(p)
    assert meta["sweeps"] == 10
    rn0 = torch.linalg.vector_norm(b.reshape(-1))
    resumed = tms.sm(op, b, x0=torch.from_numpy(x0), rtol=1e-3, maxiter=2000,
                     rnorm0=rn0)
    fresh = tms.sm(op, b, rtol=1e-3, maxiter=2000)
    assert resumed.converged
    assert int(resumed.sweeps) < int(fresh.sweeps)


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint from each package resumes in the other: the same
    iterate bit for bit, the same metadata, and the resumed solves take
    the same sweeps."""
    op, b = _port_problem()
    jop = jbo.block_poisson2d(16, 16)
    jb = jbo.rhs_ones(jop, jnp.float64)
    tpart = tms.sm(op, b, rtol=1e-14, maxiter=10)
    jpart = jms.sm(jop, jb, rtol=1e-14, maxiter=10)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_state(tpath, tpart.x, sweeps=10, label="port", rel=0.5)
    jck.save_state(jpath, jpart.x, sweeps=10, label="jax", rel=0.5)
    xt_in_j, mt = jck.load_state(tpath)
    xj_in_t, mj = tck.load_state(jpath)
    assert np.array_equal(xt_in_j, tpart.x.numpy())
    assert np.array_equal(xj_in_t, np.asarray(jpart.x))
    assert mt == {"sweeps": 10, "label": "port", "rel": 0.5}
    assert mj == {"sweeps": 10, "label": "jax", "rel": 0.5}
    rn0 = float(np.linalg.norm(np.asarray(jb).reshape(-1)))
    t_res = tms.sm(op, b, x0=torch.from_numpy(xj_in_t), rtol=1e-3,
                   maxiter=2000, rnorm0=torch.tensor(rn0, dtype=torch.float64))
    j_res = jms.sm(jop, jb, x0=jnp.asarray(xt_in_j), rtol=1e-3, maxiter=2000,
                   rnorm0=jnp.asarray(rn0))
    assert t_res.converged and bool(j_res.converged)
    assert t_res.sweeps == int(j_res.sweeps)


# -- reports --------------------------------------------------------------------

ITEMS = [
    ("Loading", 0.5, 1),
    ("I_Solver", 2.0, 10),
    ("I_Solver/Exchange", 0.4, 10),
    ("I_Solver/Exchange/Wire<&>", 0.125, 3),
    ("Convergence", 0.1, 10),
    ("Last", 1e-7, 1),
]
RECORDS = [
    {"alg": "SM", "backend": "stacked", "grid": "16x16", "rtol": 1e-3,
     "converged": True, "sweeps": 25, "cycles": 25, "inner_iters": 684,
     "elapsed_s": 0.8328, "wall_s": 5.047, "rel_rnorm": 0.000899289,
     "error_vs_ones": 0.0553547},
    {"alg": "AM<b>", "converged": False, "error": "timeout", "wall_s": 300},
    {"alg": "GMRES", "grid": "a&b.npz:64", "converged": True,
     "rel_rnorm": 9.3e-9, "device": "cpu"},
]


@pytest.mark.parametrize("fn,args", [
    ("folded", (ITEMS,)),
    ("render_flamegraph", (ITEMS, "stage <timers>")),
    ("render_xml", (ITEMS, "stage & timers")),
    ("render_xml_stylesheet", ()),
    ("render", (RECORDS, "bulk & co")),
    ("render", ([], "empty")),
])
def test_report_strings_byte_equal(fn, args):
    assert getattr(trep, fn)(*args) == getattr(jrep, fn)(*args)


def test_report_main_same_file(tmp_path):
    log = tmp_path / "runs.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n\n")
    outs = []
    for mod in (jrep, trep):
        out = tmp_path / f"{mod.__name__.split('.')[0]}.html"
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.main([str(log), "-o", str(out), "--title", "t"]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("suffix", [".html", ".txt", ".xml"])
def test_cli_flame_writes(tmp_path, suffix):
    out = tmp_path / f"fl{suffix}"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(["--alg", "SMSM_GLOBAL", "--m", "16", "--n", "16",
                        "--maxiter", "200", "--device", CPU, "--json",
                        "--flame", str(out)])
    assert rc == 0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rec["converged"] and len(rec["residual_history"]) == rec["cycles"]
    text = out.read_text()
    stages = ("I_Solver", "Exchange", "O_Solver", "Convergence")
    if suffix == ".html":
        assert all(s in text for s in stages) and "lane" in text
    elif suffix == ".txt":
        names = [ln.rsplit(" ", 1)[0] for ln in text.strip().splitlines()]
        assert set(stages) <= set(names)
    else:
        root = ET.fromstring(text)
        names = {e.findtext("name") for e in root.iter("event")}
        assert set(stages) <= names
        ET.fromstring((tmp_path / "performance_xml2html.xsl").read_text())


# -- bulk -------------------------------------------------------------------------

def test_bulk_run_one_on_the_cpu():
    rec = bulk.run_one(
        ["--alg", "SM", "--m", "8", "--n", "8", "--rtol", "1e-3",
         "--maxiter", "200", "--dtype", "float64", "--device", CPU],
        timeout_s=300, env={"OMP_NUM_THREADS": "1"},
    )
    assert rec.get("converged") is True
    assert rec["returncode"] == 0 and rec["device"] == CPU


def test_bulk_timeout_isolated():
    args = ["--alg", "SM", "--m", "8", "--n", "8", "--device", CPU]
    rec = bulk.run_one(args, timeout_s=0.01)
    assert rec == {"error": "timeout", "wall_s": 0.01, "returncode": -1,
                   "args": args}


# -- scaling and the collective tally -------------------------------------------

def test_weak_scaling_records():
    """JAX's ``TestScaling`` on the port, with JAX's record keys: two
    fixed sweeps of SM with GMRES(4) inner solves, 2 blocks x 2 sweeps x 4
    iterations at every mesh size; and the north-star variant."""
    with contextlib.redirect_stdout(io.StringIO()):
        recs = tscaling.run_weak_scaling(
            rows_per_device=8, n=16, sweeps=2, device_counts=[2, 4],
            inner_maxiter=4, device=CPU)
        ns = tscaling.run_weak_scaling(rows_per_device=4, n=8,
                                       device_counts=[2], alg="MGPCG",
                                       device=CPU)
    assert len(recs) == 2
    assert all("weak_efficiency" in r for r in recs)
    assert recs[0]["weak_efficiency"] == 1.0
    for r, g in zip(recs, ("16x16", "32x16")):
        assert set(r) == {"devices", "grid", "sweeps", "inner_iters",
                          "wall_s", "spmv_equiv_nnz_per_s",
                          "weak_efficiency"}
        assert (r["grid"], r["sweeps"], r["inner_iters"]) == (g, 2, 16)
    assert set(ns[0]) == {"devices", "grid", "refine_passes",
                          "rel_residual", "converged", "wall_s",
                          "weak_efficiency"}
    assert ns[0]["converged"] and ns[0]["refine_passes"] <= 3
    assert float(ns[0]["rel_residual"]) <= 1e-8


def _structural(alg, n):
    with contextlib.redirect_stdout(io.StringIO()):
        return tscaling.run_structural(rows_per_device=8, n=n,
                                       device_counts=[2, 4, 8], alg=alg,
                                       device=CPU)


class TestStructuralWeakScaling:
    """JAX's ``tests/test_hlostats.py::TestStructuralWeakScaling`` on the
    mesh tally, which counts calls as they run (a fixed amount of work a
    mesh size).  Bytes a shard are flat across the meshes whose blocks are
    split (4 and 8 shards: both halo classes, within a block and across
    blocks).  From the 2-shard mesh JAX's pins (SM 1.2x, MG-PCG 1.15x) do
    not carry over: with one shard a block there are no intra-block halos,
    and every inner matvec of the larger meshes exchanges them, where
    JAX's HLO counts a loop body's halos once (ROADMAP Queue 3: 4.08x and
    2.99x).  The scalar reductions are equal at every mesh size."""

    def test_sm_bytes_per_shard(self):
        recs = _structural("SM", 64)
        assert [r["devices"] for r in recs] == [2, 4, 8]
        assert all(r["collectives"]["collective-permute"]["count"] > 0
                   for r in recs)
        assert set(recs[0]) == {"devices", "grid", "collectives",
                                "total_count", "bytes_per_device",
                                "bytes_vs_smallest_mesh"}
        split = recs[1]["bytes_per_device"]
        for r in recs[1:]:
            assert r["bytes_per_device"] <= 1.2 * split
        assert recs[0]["bytes_per_device"] < split
        ar = [r["collectives"]["all-reduce"] for r in recs]
        assert all(a == ar[0] for a in ar)

    def test_mgpcg_bytes_per_shard(self):
        recs = _structural("MGPCG", 32)
        split = recs[1]["bytes_per_device"]
        for r in recs[1:]:
            assert r["bytes_per_device"] <= 1.15 * split
        assert recs[0]["bytes_per_device"] < split
        ar = [r["collectives"]["all-reduce"]["bytes"] for r in recs]
        assert max(ar) == min(ar)
        # the cycle's coarsest distributed grid gathered once a visit
        assert all(r["collectives"]["all-gather"]["count"] > 0 for r in recs)


def test_tally_counts_and_costs_no_bits():
    mesh = make_mesh(2, 4, device=CPU)
    x = torch.arange(2 * 4 * 3, dtype=torch.float64).reshape(2, 4, 3)
    with mesh.count_collectives() as st:
        mesh.psum(x, ("block", "intra"))
        mesh.pmean(x, "intra")
        mesh.pmax(x, "block")
        mesh.ppermute(x, "intra", [(0, 1)])
        mesh.ppermute(x, "intra", [])            # moves nothing
        mesh.ppermute(x, "block", [(0, 0), (1, 1)])
        with mesh.count_collectives() as inner:
            mesh.all_gather(x, "intra", axis=0, tiled=True)
    assert st["all-reduce"] == {"count": 3, "bytes": 3 * 24}
    assert st["collective-permute"] == {"count": 1, "bytes": 24}
    assert st["all-gather"] == {"count": 0, "bytes": 0}
    assert inner["all-gather"] == {"count": 1, "bytes": 4 * 24}
    assert collstats.total_collective_count(st) == 4
    assert collstats.total_collective_bytes(st) == 4 * 24
    assert mesh._tally is None
    # a solve under the tally has the bits of the solve without it
    cfg = ShardedPoisson2D(16, 16)
    b = torch.ones(16, 16, dtype=torch.float64)

    def solve():
        return sharded_multisplit_solve(mesh, cfg, b, rtol=1e-30, maxiter=3)

    plain = solve()
    with mesh.count_collectives() as stats:
        counted = solve()
    assert torch.equal(plain.x, counted.x)
    assert collstats.total_collective_count(stats) > 0
    with mesh.count_collectives() as again:
        solve()
    assert again == stats


# -- the WAN study ----------------------------------------------------------------

WAN_ROWS = [
    {"alg": "SM", "latency_ms": 0.0, "wall_s": 1.25, "sweeps": 30,
     "tail_rounds": 0, "certified": True, "rel_residual": 9.1e-5},
    {"alg": "SM", "latency_ms": 25.0, "wall_s": 4.5, "sweeps": 30,
     "tail_rounds": 0, "certified": True, "rel_residual": 9.1e-5},
    {"alg": "AM", "latency_ms": 0.0, "wall_s": 0.75, "sweeps": 41,
     "tail_rounds": 3, "certified": True, "rel_residual": 6.2e-5},
    {"alg": "SMSM_GLOBAL", "latency_ms": 25.0, "wall_s": 60.0,
     "sweeps": 4000, "tail_rounds": 0, "certified": False,
     "rel_residual": 3.3e-2},
]


def test_wan_markdown_byte_equal():
    assert twan.as_markdown(WAN_ROWS) == jwan.as_markdown(WAN_ROWS)
    assert "UNCERT" in twan.as_markdown(WAN_ROWS)


def test_wan_study_runs():
    with contextlib.redirect_stdout(io.StringIO()):
        rows = twan.run_study(m=16, latencies_ms=(0.0,), timeout_s=120,
                              device=CPU)
    assert [r["alg"] for r in rows] == ["SM", "AM", "SMSM_GLOBAL",
                                        "AMAM_GLOBAL"]
    for r in rows:
        assert r["converged"]
        if r["alg"] in ("SM", "AM"):
            assert r["certified"] and r["rel_residual"] <= 1e-4
    table = twan.as_markdown(rows)
    assert len(table.splitlines()) == 6
    for r in rows:
        line = next(ln for ln in table.splitlines()
                    if ln.startswith(f"| {r['alg']} |"))
        assert ("UNCERT" in line) == (not r["certified"])


# -- the CLI's process launches ---------------------------------------------------

def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_cli_multihost_two_ranks():
    rc, lines = _cli(["--alg", "SM", "--m", "16", "--n", "16", "--dtype",
                      "float64", "--multihost", "2", "--device", CPU])
    assert rc == 0
    report = dict(ln.split(":", 1) for ln in lines if ":" in ln)
    report = {k.strip(): v.strip() for k, v in report.items()}
    assert report["Algorithm"] == "SM (multihost(2proc))"
    assert report["Processes/shards"] == "2 x [1, 1] of mesh [2, 1]"
    assert report["Converged"] == "True"


def test_cli_net_async_two_ranks():
    rc, lines = _cli(["--alg", "AM", "--m", "16", "--n", "16",
                      "--net-async", "2", "--device", CPU, "--json"])
    rec = json.loads(lines[-1])
    assert rc == 0 and rec["converged"] and rec["certified"] is True
    assert rec["device"] == CPU and rec["rel_rnorm"] <= 1e-4
    assert len(rec["sweeps_per_block"]) == 2
