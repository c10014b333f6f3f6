"""The port's command line (``utils/cli.py``) against the JAX package's, on
the CPU.

The same argv goes to JAX's ``cli.main(argv + ["--json"])`` and to the
port's ``main(argv + ["--device", "cpu", "--json"])``: every case of JAX's
``TestCLI`` (``tests/test_cli.py``) plus a tiled SMSM_GLOBAL on (2, 2, 2),
CA_GMRES, ``--record-history``, ``--show-config`` and ``--np 8 --npb 4``.
Pinned in f64: the exit code, the record's keys (the port's are JAX's plus
``device``), sweeps and cycles equal, inner iterations within 1% (an
inner GMRES that stops on its rtol inside a sweep can stop one iteration
apart after a one-ulp difference, as in test_torch_multisplitting.py),
and ``rel_rnorm`` within a relative 1e-4 (a GMRES-inner sweep map
amplifies one ulp ~1e9).  The f32 cases (the df-refined MGPCG, stacked
and sharded) are held to JAX's bounds, not to JAX's counts (f32 counts
are not pins between the packages).  ``host_async`` is threaded, its
sweeps not deterministic: converged and certified only.  The rejected
flag combinations raise ``SystemExit`` with JAX's messages.  JAX's
records are computed once a module.
"""

import contextlib
import io
import json

import pytest
import torch

from medane_tchakorom_ufc_thesis_repository_tpu.utils import cli as jcli
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import cli as tcli

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
F64 = ["--dtype", "float64"]


def _run(main, argv):
    """``(exit code, last JSON line, every stdout line)`` of ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([*argv, "--json"])
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), lines


@pytest.fixture(scope="module")
def jax_run():
    cache = {}

    def run(argv):
        key = tuple(argv)
        if key not in cache:
            cache[key] = _run(jcli.main, argv)
        return cache[key]

    return run


def _port(argv):
    return _run(tcli.main, [*argv, *CPU])


def assert_same(jrec, trec, jrc, trc):
    assert trc == jrc
    assert set(trec) == set(jrec) | {"device"}
    assert trec["device"] == "cpu"
    assert trec["sweeps"] == jrec["sweeps"]
    assert trec["cycles"] == jrec["cycles"]
    assert abs(trec["inner_iters"] - jrec["inner_iters"]) <= \
        0.01 * jrec["inner_iters"]
    assert trec["converged"] == jrec["converged"]
    for k in ("alg", "backend", "dim", "grid"):
        assert trec[k] == jrec[k]
    assert trec["rnorm0"] == pytest.approx(jrec["rnorm0"], rel=1e-12)
    assert trec["rel_rnorm"] == pytest.approx(jrec["rel_rnorm"], rel=1e-4)
    if "certified" in jrec:
        assert trec["certified"] == jrec["certified"]
        assert trec["tail_sweeps"] == jrec["tail_sweeps"]


GRID16 = ["--m", "16", "--n", "16"]
CASES = {
    # JAX's TestCLI
    "SM": ["--alg", "SM", *GRID16, "--rtol", "1e-3", "--maxiter", "2000",
           *F64],
    "AM": ["--alg", "AM", *GRID16, "--rtol", "1e-3", "--maxiter", "2000",
           *F64],
    "SMSM_GLOBAL": ["--alg", "SMSM_GLOBAL", *GRID16, "--rtol", "1e-3",
                    "--maxiter", "2000", *F64],
    "AMAM_LOCAL": ["--alg", "AMAM_LOCAL", *GRID16, "--rtol", "1e-3",
                   "--maxiter", "2000", *F64],
    "GMRES": ["--alg", "GMRES", *GRID16, "--rtol", "1e-4", "--maxiter",
              "2000", *F64],
    "MGPCG": ["--alg", "MGPCG", "--m", "32", "--n", "32", "--rtol", "1e-6",
              *F64],
    "sharded_SM": ["--alg", "SM", "--backend", "sharded", "--nblocks", "2",
                   "--intra", "4", *GRID16, "--rtol", "1e-3", "--maxiter",
                   "1000", *F64],
    "3D_SM": ["--alg", "SM", "--dim", "3", "--m", "8", "--n", "8", "--nz",
              "8", "--rtol", "1e-3", "--maxiter", "1000", *F64],
    "nonconvergence": ["--alg", "SM", *GRID16, "--rtol", "1e-14",
                       "--maxiter", "3", *F64],
    # beyond JAX's tests
    "tiled_SMSM_GLOBAL": ["--alg", "SMSM_GLOBAL", "--backend", "tiled",
                          "--nblocks", "2", "--ir", "2", "--ic", "2",
                          *GRID16, "--rtol", "1e-3", "--maxiter", "1000",
                          *F64],
    "CA_GMRES": ["--alg", "CA_GMRES", *GRID16, "--rtol", "1e-6", "--s", "8",
                 "--maxiter", "2000", *F64],
    "history": ["--alg", "SMSM_LOCAL", *GRID16, "--rtol", "1e-3",
                "--record-history", *F64],
}
EXIT = {"nonconvergence": 2}


@pytest.mark.parametrize("case", CASES)
def test_same_record_as_jax(case, jax_run):
    argv = CASES[case]
    jrc, jrec, _ = jax_run(argv)
    trc, trec, _ = _port(argv)
    assert jrc == EXIT.get(case, 0)
    assert_same(jrec, trec, jrc, trc)
    if "residual_history" in jrec:
        assert len(trec["residual_history"]) == len(jrec["residual_history"])
        assert trec["residual_history"] == pytest.approx(
            jrec["residual_history"], rel=1e-4)


DF = ["--alg", "MGPCG", "--dim", "3", "--m", "16", "--n", "16", "--nz",
      "16", "--rtol", "1e-8", "--dtype", "float32"]


@pytest.mark.parametrize("backend", [[], ["--backend", "sharded", "--nblocks",
                                          "2", "--intra", "4"]],
                         ids=["stacked", "sharded"])
def test_mgpcg_df_refined_f32(backend, jax_run):
    # f32 below the floor: double-float refinement, JAX's bounds
    jrc, jrec, _ = jax_run(DF)
    trc, trec, _ = _port([*DF, *backend])
    assert trc == jrc == 0 and trec["converged"]
    assert set(trec) == set(jrec) | {"device"}
    assert trec["rel_rnorm"] <= 1e-8
    assert trec["refine_passes"] <= 3
    assert trec["error_vs_ones"] < 1e-5
    assert trec["cycles"] == trec["refine_passes"]


def test_host_async_converged_and_certified():
    rc, rec, _ = _port(["--alg", "AM", "--backend", "host_async", *GRID16,
                        "--rtol", "1e-3", "--maxiter", "2000", *F64])
    assert rc == 0 and rec["converged"] and rec["certified"] is True
    assert rec["rel_rnorm"] <= 1e-3
    assert len(rec["sweeps_per_block"]) == 2


def test_np_npb_derive_the_mesh(jax_run):
    """``--np 8 --npb 4`` is ``--nblocks 2 --intra 4``."""
    argv = ["--alg", "SM", "--backend", "sharded", "--np", "8", "--npb",
            "4", *GRID16, "--rtol", "1e-3", "--maxiter", "1000", *F64,
            "--show-config"]
    trc, trec, lines = _port(argv)
    resolved = json.loads(lines[0])["resolved_config"]
    assert (resolved["nblocks"], resolved["intra"]) == (2, 4)
    jrc, jrec, _ = jax_run(CASES["sharded_SM"])
    assert_same(jrec, trec, jrc, trc)


def test_show_config_equal(jax_run):
    argv = ["--alg", "SM", *GRID16, "--inner1-maxiter", "30", "--inner2-ksp",
            "cg", "--outer1-rtol", "1e-10", "--rtol", "1e-3", "--maxiter",
            "300", *F64, "--show-config"]
    jrc, jrec, jlines = jax_run(argv)
    trc, trec, tlines = _port(argv)
    jconf = json.loads(jlines[0])["resolved_config"]
    tconf = json.loads(tlines[0])["resolved_config"]
    assert tconf.pop("device") == "cpu"
    assert tconf == jconf
    assert_same(jrec, trec, jrc, trc)


def test_runs_on_the_card_by_default():
    argv = ["--alg", "SM", "--m", "8", "--n", "8", "--maxiter", "3"]
    if torch.cuda.is_available():
        rc, rec, _ = _run(tcli.main, argv)
        assert rec["device"].startswith("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run(tcli.main, argv)


def test_parser_flag_for_flag():
    """Every JAX flag with its dest, default, choices and type; the help
    too, but where the port's differs in substance (its profiler, its
    process launch); one flag more, ``--device``."""
    ja = {a.dest: a for a in jcli.build_parser()._actions}
    ta = {a.dest: a for a in tcli.build_parser()._actions}
    assert set(ta) == set(ja) | {"device"}
    for dest, a in ja.items():
        b = ta[dest]
        for f in ("option_strings", "default", "choices", "type", "nargs",
                  "metavar", "const"):
            assert getattr(b, f) == getattr(a, f), (dest, f)
        if dest not in ("profile_dir", "multihost", "devices_per_process"):
            assert b.help == a.help, dest


REJECTED = {
    "stage_timers_gmres": ["--alg", "GMRES", *GRID16, "--stage-timers"],
    "stage_timers_publish": ["--alg", "AM", *GRID16, "--stage-timers",
                             "--basis-collection", "publish"],
    "host_async_sync": ["--alg", "SM", *GRID16, "--backend", "host_async"],
    "ca_gmres_tiled": ["--alg", "CA_GMRES", *GRID16, "--backend", "tiled"],
    "gmres_host_async": ["--alg", "GMRES", *GRID16, "--backend",
                         "host_async"],
    "mgpcg_host_async": ["--alg", "MGPCG", *GRID16, "--backend",
                         "host_async"],
    "tiled_gmres_3d": ["--alg", "GMRES", "--dim", "3", "--m", "8", "--n",
                       "8", "--nz", "8", "--backend", "tiled"],
    "np_alone": ["--alg", "SM", *GRID16, "--np", "8"],
    "np_not_divisible": ["--alg", "SM", *GRID16, "--np", "6", "--npb", "4"],
    "multihost_intra": ["--alg", "SM", *GRID16, "--multihost", "2",
                        "--intra", "2"],
    "multihost_per_block": ["--alg", "SM", *GRID16, "--multihost", "2",
                            "--inner1-maxiter", "3"],
    "net_async_gmres": ["--alg", "GMRES", *GRID16, "--net-async", "2"],
}


@pytest.mark.parametrize("case", REJECTED)
def test_rejections_as_jax(case):
    argv = REJECTED[case]
    with pytest.raises(SystemExit) as je:
        _run(jcli.main, argv)
    with pytest.raises(SystemExit) as te:
        _port(argv)
    assert str(te.value) == str(je.value)


def test_devices_per_process_has_no_twin():
    with pytest.raises(SystemExit, match="no twin"):
        _port(["--alg", "SM", *GRID16, "--multihost", "2",
               "--devices-per-process", "8"])
