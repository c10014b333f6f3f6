"""The port's ``--matrix`` flag (a user's sparse matrix through the CLI)
against the JAX package's, on the CPU, in f64.

Every case of JAX's ``TestMatrixFlag`` (``tests/test_cli.py``) on the same
``.npz`` files: SMSM_GLOBAL with inner Jacobi, GMRES with ``--pc-type``
none, jacobi, bjacobi and amg, SM with inner ``bjacobi``, CA_GMRES with
the Lanczos-estimated interval, the row-sharded GMRES on a ``(2, 4)`` mesh
with no PC, jacobi (the host column scaling) and bjacobi, and the
rejected combinations.  Pinned: the exit code, the iteration or sweep
count, the record's keys (JAX's plus ``device``), ``rel_rnorm`` within a
relative 1e-4, and JAX's own bounds on the residual and the error.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from medane_tchakorom_ufc_thesis_repository_tpu.core.poisson import (
    poisson2d_coo,
)
from medane_tchakorom_ufc_thesis_repository_tpu.utils import cli as jcli
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import cli as tcli

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([*argv, "--json"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _blocky(n=64, seed=61):
    """JAX's ``TestMatrixFlag._save_blocky``: 8x8 blocks, two random
    block columns a block row, A Aᵀ + n I."""
    rng = np.random.default_rng(seed)
    nbk, c = n // 8, 8
    A = sp.lil_matrix((n, n))
    for r in range(nbk):
        for cc in rng.choice(nbk, size=2, replace=False):
            A[r*c:(r+1)*c, cc*c:(cc+1)*c] = rng.standard_normal((c, c))
    return ((A.tocsr() @ A.tocsr().T) + sp.eye(n) * n).tocsr()


def _permuted_poisson():
    rows, cols, vals, shape = poisson2d_coo(24, 24)
    perm = np.random.default_rng(13).permutation(shape[0])
    return sp.coo_matrix((vals, (perm[rows], perm[cols])),
                         shape=shape).tocsr()


@pytest.fixture(scope="module")
def mats(tmp_path_factory):
    d = tmp_path_factory.mktemp("mats")
    out = {}
    for name, A in [*[(f"blocky{s}", _blocky(seed=s))
                      for s in (61, 62, 64, 65, 66, 67, 68)],
                    ("perm", _permuted_poisson()),
                    ("rect", sp.random(64, 32, density=0.1, random_state=1,
                                       format="csr")),
                    ("odd", _blocky(n=64, seed=61)[:63, :63].tocsr())]:
        path = str(d / f"{name}.npz")
        sp.save_npz(path, A)
        out[name] = path
    out["txt"] = str(d / "mat.txt")
    return out


SHARDED = ["--backend", "sharded", "--nblocks", "2", "--intra", "4"]
CASES = {
    # name: (matrix, argv, JAX's bounds: rel_rnorm, error_vs_ones)
    "smsm_global": ("blocky61", [
        "--alg", "SMSM_GLOBAL", "--rtol", "1e-8", "--maxiter", "400", "--s",
        "4", "--inner-maxiter", "20", "--inner-rtol", "1e-10",
        "--inner-pc-type", "jacobi"], 1.05e-8, 1e-4),
    "gmres": ("blocky62", ["--alg", "GMRES", "--rtol", "1e-8", "--maxiter",
                           "4000"], 1.05e-8, None),
    "gmres_jacobi": ("blocky62", ["--alg", "GMRES", "--rtol", "1e-8",
                                  "--maxiter", "4000", "--pc-type",
                                  "jacobi"], 1.1e-8, 1e-6),
    "gmres_bjacobi": ("blocky65", ["--alg", "GMRES", "--rtol", "1e-8",
                                   "--maxiter", "4000", "--pc-type",
                                   "bjacobi", "--pc-block-size", "8"],
                      1.1e-8, 1e-6),
    "gmres_amg": ("perm", ["--alg", "GMRES", "--rtol", "1e-8", "--maxiter",
                           "4000", "--pc-type", "amg"], 1.1e-8, 1e-6),
    "sm_inner_bjacobi": ("blocky67", [
        "--alg", "SM", "--rtol", "1e-8", "--maxiter", "400",
        "--inner-maxiter", "20", "--inner-rtol", "1e-10", "--inner-pc-type",
        "bjacobi", "--inner-pc-block-size", "8"], 1.05e-8, 1e-4),
    "ca_gmres": ("blocky68", ["--alg", "CA_GMRES", "--rtol", "1e-6",
                              "--maxiter", "2000", "--s", "8"], 1.1e-6, None),
    "sharded_gmres": ("blocky64", ["--alg", "GMRES", *SHARDED, "--rtol",
                                   "1e-8", "--maxiter", "3000"], 1.05e-8,
                      1e-4),
    "sharded_gmres_jacobi": ("blocky66", [
        "--alg", "GMRES", *SHARDED, "--rtol", "1e-8", "--maxiter", "3000",
        "--pc-type", "jacobi"], None, 1e-4),
    "sharded_gmres_bjacobi": ("blocky66", [
        "--alg", "GMRES", *SHARDED, "--rtol", "1e-8", "--maxiter", "3000",
        "--pc-type", "bjacobi", "--pc-block-size", "8"], None, 1e-4),
}


@pytest.mark.parametrize("case", CASES)
def test_matrix_same_as_jax(case, mats):
    name, argv, rel_bound, err_bound = CASES[case]
    argv = ["--matrix", mats[name], "--dtype", "float64", *argv]
    jrc, jrec = _run(jcli.main, argv)
    trc, trec = _run(tcli.main, [*argv, "--device", "cpu"])
    assert jrc == trc == 0 and trec["converged"]
    assert set(trec) == set(jrec) | {"device"}
    assert trec["sweeps"] == jrec["sweeps"]
    assert trec["cycles"] == jrec["cycles"]
    assert abs(trec["inner_iters"] - jrec["inner_iters"]) <= \
        0.01 * jrec["inner_iters"]
    assert trec["grid"] == jrec["grid"] and f"{name}.npz" in trec["grid"]
    assert trec["rel_rnorm"] == pytest.approx(jrec["rel_rnorm"], rel=1e-4)
    true_rel = trec["final_true_rnorm"] / trec["rnorm0"]
    if rel_bound is not None:
        assert true_rel <= rel_bound
    if err_bound is not None:
        assert trec["error_vs_ones"] < err_bound


REJECTED = {
    "mgpcg": ("blocky61", ["--alg", "MGPCG"], SystemExit, None),
    "sm_sharded": ("blocky61", ["--alg", "SM", "--backend", "sharded"],
                   SystemExit, None),
    "ca_gmres_sharded": ("blocky61", ["--alg", "CA_GMRES", "--backend",
                                      "sharded"], SystemExit, None),
    "amg_sharded": ("blocky68", ["--alg", "GMRES", "--backend", "sharded",
                                 "--pc-type", "amg"], SystemExit, "stacked"),
    "not_square": ("rect", ["--alg", "GMRES"], SystemExit, "square"),
    "rows_not_divisible": ("odd", ["--alg", "GMRES"], SystemExit,
                           "divisible"),
    "extension": ("txt", ["--alg", "GMRES"], SystemExit, "extension"),
}


@pytest.mark.parametrize("case", REJECTED)
def test_matrix_rejections_as_jax(case, mats):
    name, argv, exc, match = REJECTED[case]
    argv = ["--matrix", mats[name], *argv]
    with pytest.raises(exc, match=match) as je:
        _run(jcli.main, argv)
    with pytest.raises(exc, match=match) as te:
        _run(tcli.main, [*argv, "--device", "cpu"])
    assert str(te.value) == str(je.value)


def test_pc_type_requires_matrix():
    argv = ["--alg", "GMRES", "--m", "32", "--n", "32", "--pc-type",
            "bjacobi"]
    with pytest.raises(ValueError, match="pc-type") as je:
        _run(jcli.main, argv)
    with pytest.raises(ValueError, match="pc-type") as te:
        _run(tcli.main, [*argv, "--device", "cpu"])
    assert str(te.value) == str(je.value)
