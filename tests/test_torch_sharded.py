"""The port's sharded multisplitting and whole-mesh Krylov baselines
(``parallel/sharded.py``, ``parallel/engine.py``) on a ``(2, 4)``
``'local'`` mesh on the CPU.

Against JAX's sharded function on its 8 virtual CPU devices, in f64 on
the same 16x16 right-hand side: SMSM_GLOBAL (sweeps equal, x to 1e-5: a
GMRES-inner map amplifies one ulp).  JAX compiles a sharded program for
seconds here, so its result is computed once per module (the whole-mesh
GMRES and CA-GMRES against JAX's are in ``test_torch_mesh.py``).  The
other cases hold the port's sharded solve against the port's own stacked
or single-device solve, which is held against JAX elsewhere (the cases of
JAX's ``tests/test_sharded.py``).  On the CPU the shards' applies run the
plain versions of kernels E and A, the projections those of F and G.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    blockops as jbo,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
    sharded as jsh,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    Stencil2D,
    Stencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    blockops,
    multisplitting as ms,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    InnerConfig,
    OuterConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    ShardedPoisson2D,
    ShardedPoisson3D,
    make_mesh,
    sharded_ca_gmres_solve,
    sharded_gmres_solve,
    sharded_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh24():
    return make_mesh(2, 4, transport="local", device=CPU)


def _rhs(m=16, n=16, dtype=torch.float64):
    sop = blockops.block_poisson2d(m, n)
    b = blockops.rhs_ones(sop, dtype, CPU)
    return sop, ShardedPoisson2D(m, n), b, b.reshape(m, n)


def _true_rel(m, n, b_grid, x_grid):
    A = Stencil2D(m, n)
    r = b_grid.reshape(-1) - A.mv(x_grid.reshape(-1))
    return float(torch.linalg.norm(r) / torch.linalg.norm(b_grid))


# ---------------------------------------------------------------------------
# Against JAX's sharded functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(mesh8):
    """JAX's sharded SMSM_GLOBAL on 16x16, f64."""
    sop = jbo.block_poisson2d(16, 16)
    b = jbo.rhs_ones(sop, jnp.float64).reshape(16, 16)
    cfg = jsh.ShardedPoisson2D(16, 16)
    smsm = jsh.sharded_multisplit_solve(mesh8, cfg, b, minimization="global",
                                        s=4, rtol=1e-6)
    return {"b": np.array(b),
            "smsm": (int(smsm.sweeps), np.asarray(smsm.x))}


class TestAgainstJax:
    def test_smsm_global(self, mesh24, jax_runs):
        sweeps, x = jax_runs["smsm"]
        b = torch.from_numpy(jax_runs["b"])
        res = sharded_multisplit_solve(mesh24, ShardedPoisson2D(16, 16), b,
                                       minimization="global", s=4, rtol=1e-6)
        assert res.sweeps == sweeps
        np.testing.assert_allclose(res.x.numpy(), x, rtol=1e-5, atol=1e-5)

    def test_config_converts(self):
        got = convert.from_jax_operator(jsh.ShardedPoisson3D(8, 6, 4),
                                        device=CPU)
        assert got == ShardedPoisson3D(8, 6, 4)
        assert got.nnz == jsh.ShardedPoisson3D(8, 6, 4).nnz


# ---------------------------------------------------------------------------
# Against the port's stacked solver (JAX's tests/test_sharded.py cases)
# ---------------------------------------------------------------------------

class TestShardedSM:
    def test_matches_stacked_exactly(self, mesh24):
        sop, cfg, b, bg = _rhs()
        res = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-3)
        st = ms.sm(sop, b, rtol=1e-3)
        assert res.sweeps == st.sweeps
        np.testing.assert_allclose(res.x.reshape(-1).numpy(),
                                   st.x.reshape(-1).numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_invariant(self, mesh24):
        _, cfg, _, bg = _rhs()
        res = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-4)
        assert res.converged
        assert _true_rel(16, 16, bg, res.x) <= 1e-4 * 1.01

    def test_3d(self, mesh24):
        sop = blockops.block_poisson3d(16, 4, 4)
        b = blockops.rhs_ones(sop, torch.float64, CPU)
        res = sharded_multisplit_solve(mesh24, ShardedPoisson3D(16, 4, 4),
                                       b.reshape(16, 4, 4), rtol=1e-4)
        st = ms.sm(sop, b, rtol=1e-4)
        assert res.sweeps == st.sweeps
        np.testing.assert_allclose(res.x.reshape(-1).numpy(),
                                   st.x.reshape(-1).numpy(), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("scope", ["local", "semi_local", "global"])
    def test_smsm(self, mesh24, scope):
        _, cfg, _, bg = _rhs()
        res = sharded_multisplit_solve(mesh24, cfg, bg, minimization=scope,
                                       s=3, rtol=1e-4)
        assert res.converged
        assert _true_rel(16, 16, bg, res.x) <= 1e-4 * 1.5

    def test_smsm_matches_stacked_sweeps(self, mesh24):
        sop, cfg, b, bg = _rhs()
        res = sharded_multisplit_solve(mesh24, cfg, bg, minimization="global",
                                       s=4, rtol=1e-4)
        st = ms.smsm(sop, b, scope="global", s=4, rtol=1e-4)
        assert res.sweeps == st.sweeps and res.cycles == st.cycles

    def test_async(self, mesh24):
        _, cfg, _, bg = _rhs()
        res = sharded_multisplit_solve(mesh24, cfg, bg, schedule="async",
                                       staleness=2, rtol=1e-3)
        assert res.converged
        assert _true_rel(16, 16, bg, res.x) <= 1e-3 * 1.5

    def test_amam_global(self, mesh24):
        _, cfg, _, bg = _rhs()
        res = sharded_multisplit_solve(mesh24, cfg, bg, schedule="async",
                                       staleness=[1, 2], minimization="global",
                                       s=3, rtol=1e-4)
        assert res.converged and res.sweeps > 0

    def test_four_blocks(self):
        mesh = make_mesh(4, 2, device=CPU)
        sop = blockops.block_poisson2d(16, 16, nblocks=4)
        b = blockops.rhs_ones(sop, torch.float64, CPU)
        res = sharded_multisplit_solve(mesh, ShardedPoisson2D(16, 16),
                                       b.reshape(16, 16), rtol=1e-3)
        st = ms.sm(sop, b, rtol=1e-3)
        assert res.sweeps == st.sweeps
        assert res.local_rnorms.shape == (4,)

    @pytest.mark.parametrize("method", ["normal", "qr", "lsqr"])
    def test_outer_methods_agree(self, mesh24, method):
        sop, cfg, b, bg = _rhs()
        res = sharded_multisplit_solve(
            mesh24, cfg, bg, minimization="global", s=4, rtol=1e-4,
            outer=OuterConfig(method=method, maxiter=50, rtol=1e-12))
        st = ms.smsm(sop, b, scope="global", s=4, rtol=1e-4,
                     outer=OuterConfig(method=method, maxiter=50, rtol=1e-12))
        assert res.converged
        assert abs(res.sweeps - st.sweeps) <= 4
        assert _true_rel(16, 16, bg, res.x) <= 1e-4 * 1.5

    @pytest.mark.parametrize("method", ["qr", "lsqr"])
    @pytest.mark.parametrize("scope", ["local", "semi_local"])
    def test_outer_methods_blockwise_scopes(self, mesh24, method, scope):
        _, cfg, _, bg = _rhs()
        res = sharded_multisplit_solve(
            mesh24, cfg, bg, minimization=scope, s=3, rtol=1e-4,
            outer=OuterConfig(method=method, maxiter=30))
        assert res.converged
        assert _true_rel(16, 16, bg, res.x) <= 1e-4 * 1.5

    @pytest.mark.parametrize("method", ["qr", "lsqr"])
    def test_f32_s8(self, mesh24, method):
        _, cfg, _, bg = _rhs(dtype=torch.float32)
        res = sharded_multisplit_solve(
            mesh24, cfg, bg, minimization="global", s=8, rtol=1e-3,
            outer=OuterConfig(method=method, maxiter=40, rtol=1e-7))
        assert res.converged and torch.isfinite(res.x).all()

    def test_publish_basis_collection(self, mesh24):
        sop, cfg, b, bg = _rhs()
        kw = dict(schedule="async", staleness=2, minimization="global", s=3,
                  rtol=1e-3, basis_collection="publish")
        res = sharded_multisplit_solve(mesh24, cfg, bg, **kw)
        st = ms.multisplit_solve(sop, b, **kw)
        assert res.converged
        assert res.sweeps == st.sweeps - st.tail_sweeps
        with pytest.raises(ValueError, match="basis_collection"):
            sharded_multisplit_solve(mesh24, cfg, bg,
                                     basis_collection="bogus")

    def test_local_rnorms_and_history(self, mesh24):
        _, cfg, _, bg = _rhs()
        res = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-3,
                                       record_history=True)
        assert res.local_rnorms.shape == (2,)
        h = res.history.numpy()
        assert np.isfinite(h[:res.cycles]).all()
        np.testing.assert_allclose(h[res.cycles - 1], res.rnorm.item())

    def test_staleness_rules(self, mesh24):
        _, cfg, _, bg = _rhs()
        with pytest.raises(ValueError, match="staleness"):
            sharded_multisplit_solve(mesh24, cfg, bg, staleness=2)
        with pytest.raises(ValueError, match="divisible"):
            sharded_multisplit_solve(mesh24, ShardedPoisson2D(12, 16),
                                     torch.zeros(12, 16, dtype=torch.float64))


class TestShardedGMRES:
    def test_matches_single_device_iterations(self, mesh24):
        _, cfg, _, bg = _rhs()
        res = sharded_gmres_solve(mesh24, cfg, bg, restart=20, rtol=1e-8)
        ref = krylov.gmres(Stencil2D(16, 16).mv, bg.reshape(-1), restart=20,
                           rtol=1e-8)
        assert int(res.iters) == int(ref.iters)
        np.testing.assert_allclose(res.x.reshape(-1).numpy(),
                                   ref.x.numpy(), rtol=1e-8)

    def test_3d(self, mesh24):
        A = Stencil3D(16, 4, 4)
        b = A.mv(torch.ones(16, 4, 4, dtype=torch.float64))
        res = sharded_gmres_solve(mesh24, ShardedPoisson3D(16, 4, 4), b,
                                  rtol=1e-8)
        ref = krylov.gmres(A.mv, b.reshape(-1), rtol=1e-8)
        assert int(res.iters) == int(ref.iters)
        np.testing.assert_allclose(res.x.numpy(), 1.0, atol=1e-6)


class TestShardedCAGMRES:
    def test_single_reduction_converges_whole_mesh(self, mesh24):
        _, cfg, _, bg = _rhs()
        res = sharded_ca_gmres_solve(mesh24, cfg, bg, s=8, rtol=1e-8)
        assert bool(res.converged)
        assert _true_rel(16, 16, bg, res.x) <= 1e-7

    def test_matches_single_device_cycles(self, mesh24):
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.castep import (
            ca_gmres,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
            poisson_strip_eig_bounds_2d,
        )

        _, cfg, _, bg = _rhs()
        lo, hi = poisson_strip_eig_bounds_2d(16, 16)
        res = sharded_ca_gmres_solve(mesh24, cfg, bg, s=8, rtol=1e-8)
        ref = ca_gmres(Stencil2D(16, 16).mv, bg.reshape(-1), s=8, rtol=1e-8,
                       lmin=lo, lmax=hi, reductions="single")
        assert int(res.iters) == int(ref.iters)

    def test_single_vs_column_reductions_agree(self, mesh24):
        _, cfg, _, bg = _rhs()
        one = sharded_ca_gmres_solve(mesh24, cfg, bg, s=6, rtol=1e-8)
        col = sharded_ca_gmres_solve(mesh24, cfg, bg, s=6, rtol=1e-8,
                                     reductions="column")
        assert bool(one.converged) and bool(col.converged)
        np.testing.assert_allclose(one.x.numpy(), col.x.numpy(), atol=1e-6)

    def test_bounds_needed(self, mesh24):
        cfg = ShardedPoisson2D(16, 16)

        class Other:
            """A strip operator with no analytic spectral bounds."""
            split_extent, fdim, global_shape = 16, 16, (16, 16)
            off, diag = cfg.off, cfg.diag
            interior_mv = staticmethod(cfg.interior_mv)

        with pytest.raises(ValueError, match="lmin/lmax"):
            sharded_ca_gmres_solve(mesh24, Other(),
                                   torch.zeros(16, 16, dtype=torch.float64))


class TestInnerAndOuterOptions:
    def test_cg_inner_rejected(self, mesh24):
        _, cfg, _, bg = _rhs()
        with pytest.raises(ValueError, match="inner methods"):
            sharded_multisplit_solve(mesh24, cfg, bg,
                                     inner=InnerConfig(method="cg"))

    def test_jacobi_pc_matches_stacked(self, mesh24):
        sop, cfg, b, bg = _rhs()
        inner = InnerConfig(pc="jacobi")
        res = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-3,
                                       inner=inner)
        st = ms.sm(sop, b, rtol=1e-3, inner=inner)
        assert res.sweeps == st.sweeps

    def test_ilu_pc_rejected(self, mesh24):
        _, cfg, _, bg = _rhs()
        with pytest.raises(ValueError, match="inner pc"):
            sharded_multisplit_solve(mesh24, cfg, bg,
                                     inner=InnerConfig(pc="ilu"))

    def test_alpha_average_matches_stacked(self, mesh24):
        sop, cfg, b, bg = _rhs()
        outer = OuterConfig(alpha_average=True)
        res = sharded_multisplit_solve(mesh24, cfg, bg, minimization="local",
                                       s=3, rtol=1e-3, outer=outer)
        st = ms.smsm(sop, b, scope="local", s=3, rtol=1e-3, outer=outer)
        assert res.sweeps == st.sweeps

    def test_cgne_outer_rejected(self, mesh24):
        _, cfg, _, bg = _rhs()
        with pytest.raises(ValueError, match="outer methods"):
            sharded_multisplit_solve(mesh24, cfg, bg, minimization="global",
                                     outer=OuterConfig(method="cgne"))

    def test_bf16_basis_works(self, mesh24):
        _, cfg, _, bg = _rhs(dtype=torch.float32)
        res = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-3,
                                       inner=InnerConfig(basis="bf16"))
        assert res.converged

    def test_warm_restart_with_pinned_rnorm0(self, mesh24):
        _, cfg, _, bg = _rhs()
        full = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-3)
        part = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-3,
                                        maxiter=5)
        rest = sharded_multisplit_solve(mesh24, cfg, bg, part.x,
                                        rnorm0=part.rnorm0, rtol=1e-3)
        assert rest.converged
        assert part.sweeps + rest.sweeps == full.sweeps
        np.testing.assert_allclose(rest.rnorm0.item(), full.rnorm0.item())

    @pytest.mark.parametrize("method", ["ca_gmres", "chebyshev"])
    def test_sm_with_dot_light_inner(self, mesh24, method):
        sop, cfg, b, bg = _rhs()
        inner = InnerConfig(method=method, restart=6, maxiter=12)
        res = sharded_multisplit_solve(mesh24, cfg, bg, rtol=1e-4,
                                       inner=inner)
        st = ms.sm(sop, b, rtol=1e-4, inner=inner)
        assert res.converged
        assert abs(res.sweeps - st.sweeps) <= 1
        with pytest.raises(ValueError, match="does not compose"):
            sharded_multisplit_solve(
                mesh24, cfg, bg, inner=InnerConfig(method=method, pc="jacobi"))
