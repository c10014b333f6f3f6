"""The port's sharded MG-PCG and double-float refinement
(``parallel/mgpcg.py``) on the ``(2, 4)`` strip mesh and the ``(2, 2, 2)``
tiled mesh, ``'local'`` transport, on the CPU.

Against JAX's sharded functions on its 8 virtual CPU devices, on the
same 16^3 problem: ``sharded_mgpcg_solve`` in f64 (PCG iterations equal,
x to 1e-10) and the north-star ``sharded_df_northstar`` (f32 solves in
double-float refinement: passes equal, x to 1e-10).  The other cases
hold the port against its own single-device solvers and the host's f64
operator (the cases of JAX's ``tests/test_mgpcg.py``).  On the CPU the
fine levels run the plain versions of kernels A and E, the gathered
coarse cycle those of A-C and M.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import (
    operators as jops,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
    mgpcg as jmg,
    sharded as jsh,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64 as jdf
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    Stencil2D,
    Stencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    ShardedPoisson2D,
    ShardedPoisson3D,
    make_mesh,
    make_tiled_mesh,
    mgpcg,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import (
    df64,
    krylov,
    multigrid,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.refine import (
    stencil3d_mv_np,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh24():
    return make_mesh(2, 4, device=CPU)


@pytest.fixture(scope="module")
def tmesh():
    return make_tiled_mesh(2, 2, 2, device=CPU)


def _ones_rhs(n=16, dtype=torch.float64):
    return Stencil3D(n, n, n).mv(torch.ones(n, n, n, dtype=dtype))


def _host_rel(n, x64):
    mv64 = stencil3d_mv_np(n, n, n)
    b64 = mv64(np.ones(n ** 3))
    return (np.linalg.norm(b64 - mv64(x64.reshape(-1)))
            / np.linalg.norm(b64))


# ---------------------------------------------------------------------------
# Against JAX's sharded functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(mesh8):
    cfg = jsh.ShardedPoisson3D(16, 16, 16)
    b = jops.Stencil3D(16, 16, 16).mv(jnp.ones((16, 16, 16), jnp.float64))
    pcg = jmg.sharded_mgpcg_solve(mesh8, cfg, b, rtol=1e-8)
    ns = jmg.sharded_df_northstar(mesh8, cfg, rtol=1e-8)
    return {"pcg": (int(pcg.iters), np.asarray(pcg.x)),
            "ns": (ns.passes, np.asarray(jdf.df_to_f64(ns.x)))}


class TestAgainstJax:
    def test_mgpcg_f64(self, mesh24, jax_runs):
        iters, x = jax_runs["pcg"]
        res = mgpcg.sharded_mgpcg_solve(mesh24, ShardedPoisson3D(16, 16, 16),
                                        _ones_rhs(), rtol=1e-8)
        assert int(res.iters) == iters
        np.testing.assert_allclose(res.x.numpy(), x, rtol=0, atol=1e-10)

    def test_northstar(self, mesh24, jax_runs):
        passes, x = jax_runs["ns"]
        res = mgpcg.sharded_df_northstar(mesh24, ShardedPoisson3D(16, 16, 16),
                                         rtol=1e-8)
        assert res.passes == passes
        np.testing.assert_allclose(df64.df_to_f64(res.x), x, rtol=0,
                                   atol=1e-10)


# ---------------------------------------------------------------------------
# The port's own cases (JAX's tests/test_mgpcg.py)
# ---------------------------------------------------------------------------

class TestPlan:
    def test_levels_stop_at_one_plane_per_device(self):
        plan = mgpcg.plan_sharded(ShardedPoisson3D(64, 64, 64), 8)
        assert plan.dims == ((64, 64, 64), (32, 32, 32), (16, 16, 16),
                             (8, 8, 8))

    def test_levels_respect_min_size(self):
        plan = mgpcg.plan_sharded(ShardedPoisson2D(64, 8), 2, min_size=4)
        assert plan.dims == ((64, 8), (32, 4))

    def test_indivisible_grid_raises(self):
        with pytest.raises(ValueError, match="not divisible"):
            mgpcg.plan_sharded(ShardedPoisson3D(12, 16, 16), 8)

    def test_plan_matches_jax(self):
        for cfg, splits in ((ShardedPoisson3D(32, 32, 32), (4, 2, 1)),
                            (ShardedPoisson2D(64, 32), 8)):
            j = jmg.plan_sharded(
                jsh.ShardedPoisson3D(32, 32, 32) if len(cfg.global_shape)
                == 3 else jsh.ShardedPoisson2D(64, 32), splits)
            assert mgpcg.plan_sharded(cfg, splits).dims == j.dims

    def test_plan_respects_both_split_axes(self, tmesh):
        plan = mgpcg.plan_sharded(ShardedPoisson3D(32, 32, 32),
                                  mgpcg._axis_splits(tmesh, 3))
        assert plan.dims == ((32, 32, 32), (16, 16, 16), (8, 8, 8),
                             (4, 4, 4))

    def test_bad_cycle_and_mesh(self, mesh24):
        with pytest.raises(ValueError, match="cycle"):
            mgpcg.plan_sharded(ShardedPoisson3D(16, 16, 16), 8, cycle="f")
        with pytest.raises(ValueError, match="mesh axes"):
            mgpcg._layout(make_mesh(2, 2, device=CPU).__class__(
                ("a", "b"), (1, 1), device=CPU))


class TestShardedMGPCG:
    def test_3d_matches_single_device_pcg_iterations(self, mesh24):
        A = Stencil3D(32, 32, 32)
        b = _ones_rhs(32, torch.float32)
        res = mgpcg.sharded_mgpcg_solve(mesh24, ShardedPoisson3D(32, 32, 32),
                                        b, rtol=1e-5, maxiter=40)
        assert bool(res.converged)
        ref = krylov.cg(A.mv, b, rtol=1e-5, maxiter=40,
                        precond=multigrid.mg_preconditioner(A))
        assert abs(int(res.iters) - ref.iters) <= 1
        r = b - A.mv(res.x)
        assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 5e-5

    def test_2d_converges_grid_independent(self, mesh24):
        iters = []
        for m in (32, 64):
            b = torch.from_numpy(np.random.RandomState(0).rand(m, m)).to(
                torch.float32)
            res = mgpcg.sharded_mgpcg_solve(mesh24, ShardedPoisson2D(m, m), b,
                                            rtol=1e-5, maxiter=40)
            assert bool(res.converged)
            iters.append(int(res.iters))
        assert iters[1] <= iters[0] + 2

    def test_3d_matches_strip_mesh(self, mesh24, tmesh):
        cfg = ShardedPoisson3D(32, 32, 32)
        b = torch.from_numpy(np.random.RandomState(3).rand(32, 32, 32)).to(
            torch.float32)
        res_t = mgpcg.sharded_mgpcg_solve(tmesh, cfg, b, rtol=1e-5,
                                          maxiter=40)
        res_s = mgpcg.sharded_mgpcg_solve(mesh24, cfg, b, rtol=1e-5,
                                          maxiter=40)
        assert bool(res_t.converged)
        assert abs(int(res_t.iters) - int(res_s.iters)) <= 1
        np.testing.assert_allclose(res_t.x.numpy(), res_s.x.numpy(),
                                   rtol=2e-4, atol=2e-5)

    def test_2d_tiled(self, tmesh):
        b = Stencil2D(32, 32).mv(torch.ones(32, 32, dtype=torch.float64))
        res = mgpcg.sharded_mgpcg_solve(tmesh, ShardedPoisson2D(32, 32), b,
                                        rtol=1e-8)
        assert bool(res.converged)
        np.testing.assert_allclose(res.x.numpy(), 1.0, atol=1e-6)

    def test_v_cycle_and_no_agglomeration(self, mesh24):
        cfg = ShardedPoisson3D(16, 16, 16)
        plan, halo_mv, _, sweep, _ = mgpcg._pieces(mesh24, cfg, 2, 4, 40, "v")
        b = mesh24.shard(_ones_rhs(), (("block", "intra"),))
        e = mgpcg._sharded_vcycle(plan, halo_mv, b, agg=None,
                                  halo_sweep=sweep)
        assert e.shape == b.shape and torch.isfinite(e).all()
        # one cycle reduces the residual of the zero guess
        assert float(torch.linalg.norm(b - halo_mv(e))) < float(
            torch.linalg.norm(b))


class TestAgglomerator:
    @pytest.mark.parametrize("which", ["strip", "tile"])
    def test_gather_slice_roundtrip(self, which, mesh24, tmesh):
        mesh = mesh24 if which == "strip" else tmesh
        dims = (8, 8, 4)
        gather, slice_local = mgpcg._make_agglomerator(mesh, None)
        g = torch.arange(float(np.prod(dims))).reshape(dims)
        tiles = mesh.shard(g, mgpcg._grid_spec(mesh))
        assert torch.equal(gather(tiles, dims), g)
        assert torch.equal(slice_local(gather(tiles, dims)), tiles)


class TestDFSlabResidual:
    @pytest.mark.parametrize("which", ["strip", "tile"])
    def test_matches_host_f64(self, which, mesh24, tmesh):
        """The halo-corrected double-float tile residual agrees with the
        host's f64 residual to double-float precision."""
        mesh = mesh24 if which == "strip" else tmesh
        rng = np.random.RandomState(7)
        n = 16
        x64, b64 = rng.rand(n, n, n), rng.rand(n, n, n)
        cfg = ShardedPoisson3D(n, n, n)
        _, halos, _ = mgpcg._make_halo_mv(mesh, 6.0, -1.0, 3)
        run = mgpcg._df_residual_pass(mesh, halos, 6.0, -1.0)
        spec = mgpcg._grid_spec(mesh)
        xd = [mesh.shard(t, spec) for t in df64.df_from_f64(x64, CPU)]
        bd = [mesh.shard(t, spec) for t in df64.df_from_f64(b64, CPU)]
        rhi, rlo, rn = run(bd[0], bd[1], xd[0], xd[1])
        r = (mesh.unshard(rhi, spec, cfg.global_shape).double()
             + mesh.unshard(rlo, spec, cfg.global_shape).double()).numpy()
        want = b64 - stencil3d_mv_np(n, n, n)(x64.reshape(-1)).reshape(
            n, n, n)
        np.testing.assert_allclose(r, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
        np.testing.assert_allclose(float(rn), np.linalg.norm(want),
                                   rtol=1e-6)


class TestShardedNorthstar:
    def test_3d_to_1e8(self, mesh24):
        res = mgpcg.sharded_df_northstar(mesh24, ShardedPoisson3D(32, 32, 32),
                                         rtol=1e-8)
        assert res.converged and res.passes <= 3
        x64 = df64.df_to_f64(res.x)
        np.testing.assert_allclose(x64, 1.0, atol=1e-7)
        rel = _host_rel(32, x64)
        assert rel <= 1e-8
        np.testing.assert_allclose(res.rnorm / res.rnorm0, rel, rtol=1e-2,
                                   atol=1e-15)

    @pytest.mark.parametrize("which", ["strip", "tile"])
    def test_single_dispatch(self, which, mesh24, tmesh):
        """The device-tested pass loop agrees with the host-loop driver."""
        mesh = mesh24 if which == "strip" else tmesh
        cfg = ShardedPoisson3D(16, 16, 16)
        a = mgpcg.sharded_df_northstar(mesh, cfg, rtol=1e-8)
        f = mgpcg.sharded_df_northstar_fused(mesh, cfg, rtol=1e-8)
        assert f.converged and f.passes == a.passes
        assert len(f.pcg_iters) == f.passes
        np.testing.assert_allclose(df64.df_to_f64(f.x), df64.df_to_f64(a.x),
                                   rtol=0, atol=1e-9)

    def test_northstar_tiled(self, tmesh):
        res = mgpcg.sharded_df_northstar(tmesh, ShardedPoisson3D(16, 16, 16),
                                         rtol=1e-8)
        assert res.converged
        x64 = df64.df_to_f64(res.x)
        np.testing.assert_allclose(x64, 1.0, atol=1e-7)
        assert _host_rel(16, x64) <= 1e-8

    def test_northstar_column_only_split(self):
        """A tiled mesh whose leading axis is unsplit (block*ir == 1) still
        feeds its column halos into the df residual."""
        mesh = make_tiled_mesh(1, 1, 2, device=CPU)
        res = mgpcg.sharded_df_northstar(mesh, ShardedPoisson3D(16, 16, 16),
                                         rtol=1e-8)
        assert res.converged
        x64 = df64.df_to_f64(res.x)
        np.testing.assert_allclose(x64, 1.0, atol=1e-7)
        assert _host_rel(16, x64) <= 1e-8

    def test_bf16_cycle_converges_on_mesh(self, monkeypatch, mesh24):
        monkeypatch.setattr(multigrid, "_BF16_CYCLE_BYTES", 1)
        cfg = ShardedPoisson3D(16, 16, 16)
        res = mgpcg.sharded_mgpcg_solve(mesh24, cfg,
                                        _ones_rhs(16, torch.float32),
                                        rtol=1e-5, maxiter=40)
        assert bool(res.converged) and int(res.iters) <= 20
