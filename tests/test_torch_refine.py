"""Port parity for the refinement family in 2D and on the host/device f64
routes (``solvers/refine.py``, ``solvers/df64.py``,
``solvers/chebyshev.estimate_eig_bounds``) and the results carried across
(``convert.py``).

The 2D double-float residual follows the JAX package's operation order:
the same f32 inputs give the same bits on the CPU.  The refinement
loops run the same f32 MG-PCG correction solve in both packages; the
f32 solves round differently, so pass counts are equal and the residual
histories agree in size (0.3 in log10), while every result is checked in
f64 on the host against its rtol.  Inputs are made with numpy from a
seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64 as jdf
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import refine as jref
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
    estimate_eig_bounds as j_estimate_eig_bounds,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import cg as jcg
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
    mg_preconditioner as jmgp,
)
import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import chebyshev as tcheb
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64 as tdf
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import refine as tref

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _host_check_2d(x64, m, n):
    mv = jref.stencil2d_mv_np(m, n)
    b = mv(np.ones(m * n))
    rel = np.linalg.norm(b - mv(np.asarray(x64).reshape(-1))) / np.linalg.norm(b)
    return rel, np.abs(np.asarray(x64) - 1.0).max()


def _solves(m, n, rtol=1e-5):
    """The same f32 MG-PCG correction solve in both packages."""
    jop, top = jpoisson.poisson2d(m, n), port.poisson2d(m, n)
    Mj, Mt = jmgp(jop), port.mg_preconditioner(top)
    solve_j = jax.jit(lambda r: jcg(jop.mv, r, maxiter=40, rtol=rtol,
                                    precond=Mj).x)
    solve_t = lambda r: port.cg(top.mv, r, maxiter=40, rtol=rtol,   # noqa: E731
                                precond=Mt).x
    return jop, top, solve_j, solve_t


class TestDf64:
    @pytest.mark.parametrize("shape", [(16, 16), (9, 14)])
    @pytest.mark.parametrize("diag,off", [(4.0, -1.0), (5.0, -1.0),
                                          (7.0, -3.0), (4.0, -0.5)])
    def test_residual_2d_bit_identical(self, shape, diag, off):
        """The coefficients take the power-of-two, the two-power and the
        Dekker products."""
        m, n = shape
        xhi, bhi = _f32(shape, 1), _f32(shape, 2)
        xlo = _f32(shape, 3) * np.float32(2.0 ** -26)
        blo = _f32(shape, 4) * np.float32(2.0 ** -26)
        rj = jdf.stencil2d_df_residual(m, n, diag, off)(
            (jnp.asarray(bhi), jnp.asarray(blo)),
            (jnp.asarray(xhi), jnp.asarray(xlo)))
        rt = tdf.stencil2d_df_residual(m, n, diag, off)(
            (torch.from_numpy(bhi), torch.from_numpy(blo)),
            (torch.from_numpy(xhi), torch.from_numpy(xlo)))
        for t, j in zip(rt, rj):
            assert t.dtype == torch.float32 and tuple(t.shape) == shape
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    def test_residual_2d_is_f64_accurate(self):
        m, n = 12, 20
        x64 = np.random.default_rng(5).standard_normal((m, n)) / 3.0
        b64 = np.random.default_rng(6).standard_normal((m, n)) / 7.0
        r = tdf.df_residual_for(port.poisson2d(m, n))(
            tdf.df_from_f64(b64, "cpu"), tdf.df_from_f64(x64, "cpu"))
        xs = tdf.df_to_f64(tdf.df_from_f64(x64, "cpu"))
        bs = tdf.df_to_f64(tdf.df_from_f64(b64, "cpu"))
        ref = bs - jref.stencil2d_mv_np(m, n)(xs).reshape(m, n)
        np.testing.assert_allclose(tdf.df_to_f64(r), ref, rtol=0, atol=1e-12)

    def test_scale_pow2_and_scaled_norm(self):
        hi, lo = _f32((5, 6), 7), _f32((5, 6), 8) * np.float32(2.0 ** -25)
        sj = jdf.df_scale_pow2((jnp.asarray(hi), jnp.asarray(lo)), 0.25)
        st = tdf.df_scale_pow2((torch.from_numpy(hi), torch.from_numpy(lo)), 0.25)
        for t, j in zip(st, sj):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        tiny = hi * np.float32(1e-11)
        np.testing.assert_allclose(
            float(tdf.scaled_norm(torch.from_numpy(tiny), axes=None)),
            float(jdf.scaled_norm(jnp.asarray(tiny))), rtol=1e-6)
        with pytest.raises(NotImplementedError, match="mesh"):
            tdf.scaled_norm(torch.from_numpy(tiny), axes="block")

    def test_df_residual_for_rejects(self):
        with pytest.raises(TypeError, match="Stencil2D/Stencil3D"):
            tdf.df_residual_for(object())


class TestNorthstar2D:
    def test_matches_jax_at_64(self):
        """``df_northstar_fused`` on a ``Stencil2D`` in both packages: the
        same pass count, both to 1e-8 checked in f64 on the host."""
        m = n = 64
        rj = jref.df_northstar_fused(jpoisson.poisson2d(m, n), rtol=1e-8)
        b = jref.stencil2d_mv_np(m, n)(np.ones(m * n)).reshape(m, n)
        b_df = convert.df_pair_from_numpy(b.astype(np.float32),
                                          np.zeros_like(b, np.float32), "cpu")
        rt = port.df_northstar_fused(port.poisson2d(m, n), b_df, rtol=1e-8)
        assert rt.converged and rj.converged
        assert rt.passes == rj.passes <= 3
        assert len(rt.pcg_iters) == rt.passes
        assert rt.syncs == sum(rt.pcg_iters) + 2 * rt.passes + 2
        for x64 in (tdf.df_to_f64(rt.x), jdf.df_to_f64(rj.x)):
            rel, err = _host_check_2d(x64, m, n)
            assert rel <= 1e-8 and err <= 1e-6
        np.testing.assert_allclose(rt.rnorm0, rj.rnorm0, rtol=1e-5)

    @pytest.mark.parametrize("cycle", ["w", "v"])
    def test_builds_b_on_device(self, cycle):
        r = port.df_northstar_fused(port.poisson2d(32, 48), rtol=1e-8,
                                    cycle=cycle, device="cpu")
        rel, err = _host_check_2d(tdf.df_to_f64(r.x), 32, 48)
        assert r.converged and r.passes <= 3 and rel <= 1e-8 and err <= 1e-6

    def test_df_iterative_refinement_2d(self):
        m = n = 32
        jop, top, solve_j, solve_t = _solves(m, n)
        b64 = jref.stencil2d_mv_np(m, n)(np.ones(m * n)).reshape(m, n)
        rj = jref.df_iterative_refinement(jop, b64, solve_j, rtol=1e-10)
        rt = tref.df_iterative_refinement(top, b64, solve_t, rtol=1e-10,
                                          device="cpu")
        assert rt.converged and rj.converged and rt.passes == rj.passes
        np.testing.assert_allclose(np.log10(rt.rel_history),
                                   np.log10(rj.rel_history), atol=0.3)
        np.testing.assert_allclose(rt.x, 1.0, atol=1e-9)
        res = convert.refine_result_to_numpy(rt)
        back = convert.refine_result_from_numpy(res, "cpu")
        assert back.passes == rt.passes and back.converged
        np.testing.assert_array_equal(back.x, rt.x)


class TestHostAndDeviceF64:
    def test_iterative_refinement_matches_jax(self):
        m = n = 32
        _, _, solve_j, solve_t = _solves(m, n)
        mv = jref.stencil2d_mv_np(m, n)
        b = mv(np.ones(m * n))
        rj = jref.iterative_refinement(solve_j, mv, b, rtol=1e-10)
        rt = tref.iterative_refinement(solve_t, tref.stencil2d_mv_np(m, n), b,
                                       rtol=1e-10, device="cpu")
        assert rt.converged and rj.converged and rt.passes == rj.passes
        assert len(rt.rel_history) == len(rj.rel_history)
        np.testing.assert_allclose(np.log10(rt.rel_history),
                                   np.log10(rj.rel_history), atol=0.3)
        assert rt.x.dtype == np.float64
        np.testing.assert_allclose(rt.x, 1.0, atol=1e-9)

    @pytest.mark.parametrize("dim", [2, 3])
    def test_device_iterative_refinement_matches_jax(self, dim):
        """The f64 residual on the device: the stencils' ``mv`` evaluates
        in its argument's dtype in both packages."""
        if dim == 2:
            jop, top, solve_j, solve_t = _solves(32, 32)
            shape = (32, 32)
        else:
            shape = (16, 16, 16)
            jop, top = jpoisson.poisson3d(*shape), port.poisson3d(*shape)
            Mj, Mt = jmgp(jop), port.mg_preconditioner(top)
            solve_j = jax.jit(lambda r: jcg(jop.mv, r, maxiter=40, rtol=1e-5,
                                            precond=Mj).x)
            solve_t = lambda r: port.cg(top.mv, r, maxiter=40,   # noqa: E731
                                        rtol=1e-5, precond=Mt).x
        b = np.asarray(jop.mv(jnp.ones(shape)))
        rj = jref.device_iterative_refinement(jop.mv, b, solve_j, rtol=1e-10)
        rt = tref.device_iterative_refinement(top.mv, b, solve_t, rtol=1e-10,
                                              device="cpu")
        assert rt.converged and rj.converged and rt.passes == rj.passes
        np.testing.assert_allclose(np.log10(rt.rel_history),
                                   np.log10(rj.rel_history), atol=0.3)
        assert rt.x.shape == shape and rt.x.dtype == np.float64
        np.testing.assert_allclose(rt.x, 1.0, atol=1e-9)
        # one norm read per pass, plus the right-hand side's
        assert rt.syncs == rt.passes + 1

    def test_stopping_and_zero_rhs(self):
        m = n = 16
        _, top, _, solve_t = _solves(m, n)
        mv = tref.stencil2d_mv_np(m, n)
        b = mv(np.ones(m * n))
        for r in (tref.iterative_refinement(solve_t, mv, b, rtol=1e-15,
                                            max_passes=1, device="cpu"),
                  tref.device_iterative_refinement(top.mv, b, solve_t,
                                                   rtol=1e-15, max_passes=1,
                                                   device="cpu")):
            assert r.passes == 1 and not r.converged
            assert len(r.rel_history) == 2
        for r in (tref.iterative_refinement(solve_t, mv, np.zeros(m * n),
                                            device="cpu"),
                  tref.device_iterative_refinement(top.mv, np.zeros((m, n)),
                                                   solve_t, device="cpu")):
            assert r.converged and r.passes == 0 and not np.any(r.x)

    def test_host_matvec_matches_jax(self):
        x = np.random.default_rng(0).standard_normal(5 * 7)
        np.testing.assert_array_equal(tref.stencil2d_mv_np(5, 7)(x),
                                      jref.stencil2d_mv_np(5, 7)(x))
        np.testing.assert_array_equal(
            tref.stencil2d_mv_np(5, 7, 5.0, -0.5)(x),
            jref.stencil2d_mv_np(5, 7, 5.0, -0.5)(x))


class TestEstimateEigBounds:
    def test_same_start_vector_same_bounds(self, monkeypatch):
        """JAX and PyTorch draw different numbers from one seed: with the
        port's draw replaced by JAX's the two power iterations agree."""
        m, n = 12, 16
        jop, top = jpoisson.poisson2d(m, n), port.poisson2d(m, n)
        v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (m * n,),
                                          jnp.float64))
        monkeypatch.setattr(
            tcheb.torch, "randn",
            lambda *a, **kw: torch.from_numpy(v0.copy()).to(kw["dtype"]))
        lj = j_estimate_eig_bounds(jop.mv, m * n, jnp.float64, seed=3)
        lt = tcheb.estimate_eig_bounds(top.mv, m * n, torch.float64, seed=3,
                                       device="cpu")
        np.testing.assert_allclose(lt, lj, rtol=1e-10)

    def test_own_draw_brackets_the_spectrum_top(self):
        m, n = 12, 16
        top = port.poisson2d(m, n)
        lmin, lmax = tcheb.estimate_eig_bounds(top.mv, m * n, device="cpu")
        true_max = 4.0 + 2.0 * (np.cos(np.pi / (m + 1)) + np.cos(np.pi / (n + 1)))
        assert lmin == pytest.approx(lmax / 30.0)
        assert 0.9 * true_max <= lmax <= 1.06 * true_max
        # the same seed gives the same estimate; another seed another draw
        assert (lmin, lmax) == tcheb.estimate_eig_bounds(top.mv, m * n,
                                                         device="cpu")


class TestConvertRefineResult:
    def test_df_pair_round_trip(self):
        r = port.df_northstar_fused(port.poisson2d(16, 16), rtol=1e-8,
                                    device="cpu")
        fields = convert.refine_result_to_numpy(r)
        assert isinstance(fields["x"], tuple) and fields["x"][0].dtype == np.float32
        back = convert.refine_result_from_numpy(fields, "cpu")
        assert back.passes == r.passes and back.pcg_iters == r.pcg_iters
        assert back.syncs == r.syncs and back.converged == r.converged
        for a, b in zip(back.x, r.x):
            assert torch.equal(a, b)

    def test_from_the_jax_result(self):
        rj = jref.df_northstar_fused(jpoisson.poisson2d(16, 16), rtol=1e-8)
        fields = {"x": tuple(np.asarray(t) for t in rj.x), "passes": rj.passes,
                  "rel_history": rj.rel_history, "rnorm": rj.rnorm,
                  "rnorm0": rj.rnorm0, "converged": rj.converged}
        r = convert.refine_result_from_numpy(fields, "cpu")
        assert r.passes == rj.passes and r.converged and r.pcg_iters == []
        rel, err = _host_check_2d(tdf.df_to_f64(r.x), 16, 16)
        assert rel <= 1e-8 and err <= 1e-6
