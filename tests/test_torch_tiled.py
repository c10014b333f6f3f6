"""The port's 2D- and 3D-tiled sharded multisplitting and whole-mesh
GMRES (``parallel/tiled.py``) on a ``(2, 2, 2)`` ``('block', 'ir',
'ic')`` ``'local'`` mesh on the CPU.

Against JAX's ``tiled_multisplit_solve`` on its 8 virtual CPU devices:
SM on 16x16 in f64, sweeps equal (x to 1e-5: a GMRES-inner map amplifies
one ulp); JAX compiles it once per module.  The other cases hold the
port's tiled solves against its own stacked and single-device solvers
(the cases of JAX's ``tests/test_tiled.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    blockops as jbo,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
    tiled as jtl,
)
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
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    make_tiled_mesh,
    tiled_gmres_solve,
    tiled_gmres_solve_3d,
    tiled_multisplit_solve,
    tiled_multisplit_solve_3d,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh222():
    return make_tiled_mesh(2, 2, 2, device=CPU)


def _setup(m=16, n=16):
    sop = blockops.block_poisson2d(m, n)
    b = blockops.rhs_ones(sop, torch.float64, CPU)
    return sop, b, b.reshape(m, n)


def _setup3(nx=8, ny=8, nz=4):
    sop = blockops.block_poisson3d(nx, ny, nz)
    b = blockops.rhs_ones(sop, torch.float64, CPU)
    return sop, b, b.reshape(nx, ny, nz)


def _rel2(b, x):
    A = Stencil2D(*b.shape)
    return float(torch.linalg.norm(b.reshape(-1) - A.mv(x.reshape(-1)))
                 / torch.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_sm():
    mesh = jtl.make_tiled_mesh(2, 2, 2)
    b = jbo.rhs_ones(jbo.block_poisson2d(16, 16), jnp.float64).reshape(16, 16)
    res = jtl.tiled_multisplit_solve(mesh, 16, 16, b, rtol=1e-6)
    return np.array(b), int(res.sweeps), np.asarray(res.x)


class TestAgainstJax:
    def test_sm_sweeps(self, mesh222, jax_sm):
        b, sweeps, x = jax_sm
        res = tiled_multisplit_solve(mesh222, 16, 16, torch.from_numpy(b),
                                     rtol=1e-6)
        assert res.sweeps == sweeps
        np.testing.assert_allclose(res.x.numpy(), x, rtol=1e-5, atol=1e-5)


class TestTiledGMRES:
    def test_matches_single_device_iterations(self, mesh222):
        _, _, bg = _setup()
        res = tiled_gmres_solve(mesh222, 16, 16, bg, restart=20, rtol=1e-8)
        ref = krylov.gmres(Stencil2D(16, 16).mv, bg.reshape(-1), restart=20,
                           rtol=1e-8)
        assert int(res.iters) == int(ref.iters)
        np.testing.assert_allclose(res.x.reshape(-1).numpy(), ref.x.numpy(),
                                   rtol=1e-8)

    def test_3d_matches_single_device_iterations(self, mesh222):
        A = Stencil3D(8, 8, 4)
        b = A.mv(torch.ones(8, 8, 4, dtype=torch.float64))
        res = tiled_gmres_solve_3d(mesh222, 8, 8, 4, b, rtol=1e-8)
        ref = krylov.gmres(A.mv, b.reshape(-1), rtol=1e-8)
        assert int(res.iters) == int(ref.iters)
        np.testing.assert_allclose(res.x.reshape(-1).numpy(), ref.x.numpy(),
                                   rtol=1e-8)


class TestTiledMultisplit:
    def test_sm_matches_stacked(self, mesh222):
        sop, b, bg = _setup()
        res = tiled_multisplit_solve(mesh222, 16, 16, bg, rtol=1e-3)
        st = ms.sm(sop, b, rtol=1e-3)
        assert res.sweeps == st.sweeps
        np.testing.assert_allclose(res.x.reshape(-1).numpy(),
                                   st.x.reshape(-1).numpy(), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("scope", ["local", "semi_local", "global"])
    def test_minimization_scopes(self, mesh222, scope):
        _, _, bg = _setup()
        res = tiled_multisplit_solve(mesh222, 16, 16, bg, minimization=scope,
                                     s=3, rtol=1e-4)
        assert res.converged
        assert _rel2(bg, res.x) <= 1e-4 * 1.5

    def test_async(self, mesh222):
        _, _, bg = _setup()
        res = tiled_multisplit_solve(mesh222, 16, 16, bg, schedule="async",
                                     staleness=2, rtol=1e-3)
        assert res.converged
        assert _rel2(bg, res.x) <= 1e-3 * 1.5

    def test_column_only_tiling(self):
        mesh = make_tiled_mesh(2, 1, 4, device=CPU)
        sop, b, bg = _setup()
        res = tiled_multisplit_solve(mesh, 16, 16, bg, rtol=1e-3)
        st = ms.sm(sop, b, rtol=1e-3)
        assert res.sweeps == st.sweeps
        assert res.local_rnorms.shape == (2,)

    def test_indivisible_rejected(self, mesh222):
        with pytest.raises(ValueError, match="not divisible"):
            tiled_multisplit_solve(mesh222, 16, 15,
                                   torch.zeros(16, 15, dtype=torch.float64))
        with pytest.raises(ValueError, match="b must be"):
            tiled_multisplit_solve(mesh222, 16, 16,
                                   torch.zeros(8, 16, dtype=torch.float64))

    @pytest.mark.parametrize("method", ["ca_gmres", "chebyshev"])
    def test_dot_light_inner_dispatched(self, mesh222, method):
        sop, b, bg = _setup()
        inner = InnerConfig(method=method, restart=6, maxiter=12)
        res = tiled_multisplit_solve(mesh222, 16, 16, bg, rtol=1e-4,
                                     inner=inner)
        st = ms.sm(sop, b, rtol=1e-4, inner=inner)
        assert res.converged
        assert abs(res.sweeps - st.sweeps) <= 1

    def test_cg_inner_rejected(self, mesh222):
        _, _, bg = _setup()
        with pytest.raises(ValueError, match="inner methods"):
            tiled_multisplit_solve(mesh222, 16, 16, bg,
                                   inner=InnerConfig(method="cg"))


class TestTiled3D:
    def test_3d_matches_stacked(self, mesh222):
        sop, b, bg = _setup3()
        res = tiled_multisplit_solve_3d(mesh222, 8, 8, 4, bg, rtol=1e-4)
        st = ms.sm(sop, b, rtol=1e-4)
        assert res.sweeps == st.sweeps
        np.testing.assert_allclose(res.x.reshape(-1).numpy(),
                                   st.x.reshape(-1).numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_3d_minimization(self, mesh222):
        sop, b, bg = _setup3()
        res = tiled_multisplit_solve_3d(mesh222, 8, 8, 4, bg,
                                        minimization="global", s=3, rtol=1e-5)
        st = ms.smsm(sop, b, scope="global", s=3, rtol=1e-5)
        assert res.converged and res.sweeps == st.sweeps

    def test_3d_async(self, mesh222):
        _, _, bg = _setup3()
        res = tiled_multisplit_solve_3d(mesh222, 8, 8, 4, bg,
                                        schedule="async", staleness=[1, 2],
                                        rtol=1e-4)
        assert res.converged
        A = Stencil3D(8, 8, 4)
        rel = float(torch.linalg.norm(bg.reshape(-1) - A.mv(res.x.reshape(
            -1))) / torch.linalg.norm(bg))
        assert rel <= 1e-4 * 1.5
