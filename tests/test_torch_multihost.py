"""The port's multi-process execution (``utils/multihost.py``), the
threaded asynchronous solve with sharded blocks
(``models/host_async.host_async_solve(intra > 1)``) and the multi-device
dry run (``parallel/dryrun.py``), on the CPU.

One configuration, SM on 2D 16x16 in f64 with the worker's inner
defaults, runs three ways: JAX's ``sharded_multisplit_solve`` on its 8
virtual CPU devices (sweeps equal, x to 1e-5: a GMRES-inner map
amplifies one ulp), the port's ``'local'`` mesh, and 2 gloo ranks of the
port's ``'dist'`` mesh through ``launch`` (sweeps equal to the local
mesh's, x to 1e-12: both transports reduce over 'intra' first and
'block' second, and two ranks sum in one order).  Rank cases run under a
60 s limit.  Further multi-process cases are marked ``slow``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    blockops as jbo,
    multisplitting as jms,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
    sharded as jsh,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    blockops,
    host_async,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    ShardedPoisson2D,
    make_mesh,
    sharded_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import multihost

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = "cpu"
# the worker's inner defaults
INNER = dict(restart=8, maxiter=8, rtol=1e-6)


def _b16():
    cfg = ShardedPoisson2D(16, 16)
    return cfg, multihost._global_stencil_apply(
        cfg, torch.ones(16, 16, dtype=torch.float64))


@pytest.fixture(scope="module")
def local_sm():
    cfg, b = _b16()
    return sharded_multisplit_solve(make_mesh(2, 4, device=CPU), cfg, b,
                                    rtol=1e-6, inner=InnerConfig(**INNER))


def test_local_sm_matches_jax(mesh8, local_sm):
    b = jbo.rhs_ones(jbo.block_poisson2d(16, 16), jnp.float64).reshape(16, 16)
    res = jsh.sharded_multisplit_solve(mesh8, jsh.ShardedPoisson2D(16, 16), b,
                                       rtol=1e-6,
                                       inner=jms.InnerConfig(**INNER))
    assert local_sm.sweeps == int(res.sweeps)
    np.testing.assert_allclose(local_sm.x.numpy(), np.asarray(res.x),
                               rtol=1e-5, atol=1e-5)


def test_dist_two_gloo_ranks_match_local(local_sm, tmp_path):
    out = tmp_path / "x.npy"
    ranks = multihost.launch(
        ["--alg", "SM", "--m", "16", "--n", "16", "--nblocks", "2",
         "--intra", "4", "--rtol", "1e-6", "--save-x", str(out)],
        num_processes=2, device="cpu", backend="gloo", timeout_s=60)
    assert [r["local_shards"] for r in ranks] == [[1, 4], [1, 4]]
    for r in ranks:
        assert r["sweeps"] == local_sm.sweeps and r["converged"]
        assert r["rnorm"] == local_sm.rnorm.item()
    np.testing.assert_allclose(np.load(out), local_sm.x.numpy(), rtol=0,
                               atol=1e-12)


class TestWorker:
    def test_unknown_alg_fails_loudly(self):
        with pytest.raises(SystemExit, match="does not implement"):
            multihost.worker_main(["--coordinator", "localhost:1",
                                   "--num-processes", "1", "--process-id",
                                   "0", "--alg", "CHOLESKY"])

    def test_parser_defaults(self):
        args = multihost._build_parser().parse_args(
            ["--coordinator", "h:1", "--num-processes", "2",
             "--process-id", "1"])
        assert (args.device, args.backend, args.alg) == ("cuda", "gloo",
                                                         "SMSM_GLOBAL")
        assert args.inner_maxiter is None and args.intra is None

    def test_global_stencil_apply(self):
        cfg, b = _b16()
        want = blockops.rhs_ones(blockops.block_poisson2d(16, 16),
                                 torch.float64, CPU).reshape(16, 16)
        assert torch.equal(b, want)


class TestHostAsyncIntra:
    def test_intra_two_converges(self):
        op = blockops.block_poisson2d(16, 16)
        b = blockops.rhs_ones(op, torch.float64, CPU)
        res = host_async.host_async_solve(op, b, rtol=1e-3, intra=2,
                                          join_timeout_s=60)
        assert res.converged and res.certified
        assert res.rnorm <= 1e-3 * res.rnorm0 * 1.5

    def test_intra_rules(self):
        op = blockops.block_poisson2d(16, 16)
        b = blockops.rhs_ones(op, torch.float64, CPU)
        with pytest.raises(ValueError, match="no minimization"):
            host_async.host_async_solve(op, b, intra=2, minimization="local")
        with pytest.raises(ValueError, match="not divisible"):
            host_async.host_async_solve(op, b, intra=3)

    def test_sharded_sweep_matches_block_sweep(self):
        """One sweep of a block over a 4-shard sub-mesh against the
        single-device sweep of the same block."""
        op = blockops.block_poisson2d(16, 16)
        b = blockops.rhs_ones(op, torch.float64, CPU)
        cfg = host_async._intra_config(op, 4, None)
        inner = InnerConfig()
        x0 = torch.zeros(op.block_size, dtype=torch.float64)
        xs, pre_s = host_async._sharded_sweep(cfg, 4, inner, CPU)(b[0], x0)
        xr, pre_r = host_async._gmres_sweep(host_async._block_mv(op, 0),
                                            inner)(b[0], x0)
        np.testing.assert_allclose(xs.numpy(), xr.numpy(), rtol=1e-10)
        np.testing.assert_allclose(pre_s.item(), pre_r.item(), rtol=1e-14)


def test_dryrun_multichip(capsys):
    dryrun_multichip(8, device=CPU)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " OK" in ln]
    assert len(lines) == 7
    assert lines[0].startswith("dryrun_multichip OK: mesh=(2x4)")


@pytest.mark.slow
class TestMoreRanks:
    def test_smsm_global_four_processes(self):
        ranks = multihost.launch(
            ["--alg", "SMSM_GLOBAL", "--m", "16", "--n", "16", "--intra",
             "4", "--rtol", "1e-6"], num_processes=4, device="cpu",
            timeout_s=120)
        assert [r["local_shards"] for r in ranks] == [[1, 2]] * 4
        assert all(r["converged"] for r in ranks)
        assert len({r["sweeps"] for r in ranks}) == 1

    def test_mgpcg_northstar(self):
        ranks = multihost.launch(
            ["--alg", "MGPCG", "--dim", "3", "--m", "16", "--n", "16",
             "--nz", "16", "--dtype", "float32", "--rtol", "1e-8"],
            num_processes=2, device="cpu", timeout_s=120)
        for r in ranks:
            assert r["converged"] and r["err_vs_ones"] < 1e-6

    def test_gmres_baseline(self):
        ranks = multihost.launch(
            ["--alg", "GMRES", "--m", "16", "--n", "16", "--rtol", "1e-8"],
            num_processes=2, device="cpu", timeout_s=120)
        assert all(r["converged"] for r in ranks)
        assert ranks[0]["sweeps"] == ranks[1]["sweeps"]
