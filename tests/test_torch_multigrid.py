"""Port parity for the multigrid cycle, Chebyshev and CG
(``solvers/multigrid.py``, ``solvers/chebyshev.py``, ``solvers/krylov.py``).

In f64 the port's cycle and the JAX package's compute the same
operations up to summation order, so cycles agree to rtol 1e-10 and PCG
takes exactly the JAX package's iteration counts.  Inputs are made with
numpy from a seed and given to both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov as jkr
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import multigrid as jmg
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
    chebyshev as jcheb,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov as tkr
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid as tmg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    chebyshev as tcheb,
)


def _ops(dims):
    return jpoisson.poisson3d(*dims), tpoisson.poisson3d(*dims)


def _rhs(dims, seed=0):
    return np.random.default_rng(seed).standard_normal(dims)


class TestPlan:
    @pytest.mark.parametrize("dims", [(32, 16, 8), (64, 64, 64), (48, 48, 48),
                                      (5, 5, 5), (512, 512, 512)])
    @pytest.mark.parametrize("cycle", ["v", "w"])
    def test_levels_match(self, dims, cycle):
        jop, top = _ops(dims)
        lj, lt = jmg.plan(jop, cycle=cycle), tmg.plan(top, cycle=cycle)
        assert lt.dims == lj.dims
        assert (lt.diag, lt.off, lt.nu, lt.coarse_iters, lt.cycle) == (
            lj.diag, lj.off, lj.nu, lj.coarse_iters, lj.cycle)

    def test_rejects(self):
        with pytest.raises(ValueError, match="cycle"):
            tmg.plan(tpoisson.poisson3d(8, 8, 8), cycle="f")
        with pytest.raises(TypeError):
            tmg.plan(object())

    def test_bf16_threshold_and_bounds_match(self):
        assert tmg._BF16_CYCLE_BYTES == jmg._BF16_CYCLE_BYTES
        for dims in [(4, 4, 4), (8, 16, 32)]:
            np.testing.assert_allclose(tmg._dirichlet_bounds(dims, 6.0, -1.0),
                                       jmg._dirichlet_bounds(dims, 6.0, -1.0),
                                       rtol=1e-15)


class TestCycleF64:
    @pytest.mark.parametrize("n", [16, 32])
    @pytest.mark.parametrize("cycle,nu", [("w", 2), ("v", 2), ("w", 1),
                                          ("v", 0)])
    def test_vcycle(self, n, cycle, nu):
        dims = (n, n, n)
        jop, top = _ops(dims)
        b = _rhs(dims, n)
        zj = jmg.vcycle(jmg.plan(jop, cycle=cycle, nu=nu), jnp.asarray(b))
        zt = tmg.vcycle(tmg.plan(top, cycle=cycle, nu=nu), torch.from_numpy(b))
        assert zt.dtype == torch.float64
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-10,
                                   atol=1e-12)

    @pytest.mark.parametrize("n", [16, 32])
    def test_preconditioner(self, n):
        dims = (n, n, n)
        jop, top = _ops(dims)
        r = _rhs(dims, 100 + n).reshape(-1)
        zj = jmg.mg_preconditioner(jop)(jnp.asarray(r))
        zt = tmg.mg_preconditioner(top)(torch.from_numpy(r))
        assert tuple(zt.shape) == r.shape
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-10,
                                   atol=1e-12)
        # return_rdot: the same z, plus r·z taken as an f32 sum
        (zdj, dj) = jmg.mg_preconditioner(jop, return_rdot=True)(jnp.asarray(r))
        (zdt, dt_) = tmg.mg_preconditioner(top, return_rdot=True)(
            torch.from_numpy(r).reshape(dims))
        np.testing.assert_allclose(zdt.reshape(-1).numpy(), np.asarray(zdj),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(dt_), float(dj), rtol=1e-5)

    def test_symmetric(self):
        top = tpoisson.poisson3d(8, 8, 8)
        M = tmg.mg_preconditioner(top)
        u = torch.from_numpy(_rhs((512,), 1))
        v = torch.from_numpy(_rhs((512,), 2))
        a, b = float(torch.dot(M(u), v)), float(torch.dot(u, M(v)))
        assert abs(a - b) < 1e-10 * max(abs(a), 1.0)

    def test_transfers_match(self):
        dims, coarse = (8, 6, 10), (4, 3, 5)
        r, e = _rhs(dims, 3), _rhs(coarse, 4)
        np.testing.assert_allclose(
            tmg._restrict(torch.from_numpy(r), dims).numpy(),
            np.asarray(jmg._restrict(jnp.asarray(r), dims)), rtol=1e-15)
        np.testing.assert_array_equal(
            tmg._prolong(torch.from_numpy(e), coarse).numpy(),
            np.asarray(jmg._prolong(jnp.asarray(e), coarse)))

    def test_chebyshev(self):
        dims = (8, 8, 8)
        jop, top = _ops(dims)
        b = _rhs(dims, 5)
        lmin, lmax = tmg._dirichlet_bounds(dims, 6.0, -1.0)
        rj = jcheb(jop.mv, jnp.asarray(b), lmin=lmin, lmax=lmax, maxiter=40)
        rt = tcheb(top.mv, torch.from_numpy(b), lmin=lmin, lmax=lmax,
                   maxiter=40)
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10,
                                   atol=1e-13)
        np.testing.assert_allclose(float(rt.resnorm), float(rj.resnorm),
                                   rtol=1e-8)
        assert rt.iters == 40 and not bool(rt.converged)


class TestPCGIterationsF64:
    """PCG iteration counts equal the JAX package's, in f64 (the 3D case
    of ``tests/test_multigrid.py:90-114``, W against V, and plain CG)."""

    @pytest.mark.parametrize("dims,precond", [
        ((32, 32, 32), "w"), ((32, 32, 32), "v"), ((16, 16, 16), "w"),
        ((16, 16, 16), None)])
    def test_counts_match(self, dims, precond):
        jop, top = _ops(dims)
        b = np.array(jpoisson.rhs_for_exact_ones(jop), np.float64).reshape(dims)
        pj = pt = None
        if precond is not None:
            pj = jmg.mg_preconditioner(jop, cycle=precond)
            pt = tmg.mg_preconditioner(top, cycle=precond)
        maxiter = 50 if precond else 500
        rj = jkr.cg(jop.mv, jnp.asarray(b), rtol=1e-8, maxiter=maxiter,
                    precond=pj)
        rt = tkr.cg(top.mv, torch.from_numpy(b), rtol=1e-8, maxiter=maxiter,
                    precond=pt)
        assert bool(rt.converged) and bool(rj.converged)
        assert rt.iters == int(rj.iters)
        assert rt.syncs == rt.iters + 1
        if precond:
            assert rt.iters <= 20
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8)
        assert float((rt.x - 1.0).abs().max()) < 1e-6

    def test_w_no_worse_than_v(self):
        top = tpoisson.poisson3d(32, 32, 32)
        b = tpoisson.rhs_for_exact_ones(top, torch.float64, "cpu")
        its = {c: tkr.cg(top.mv, b, rtol=1e-8, maxiter=50,
                         precond=tmg.mg_preconditioner(top, cycle=c)).iters
               for c in ("w", "v")}
        assert its["w"] <= its["v"]

    def test_fused_hooks_f32(self):
        """cg(matvec_dot=mv_dot, precond_dot=M_dot) as the north-star
        calls it, f32: converges like the JAX package's, within one
        iteration (the dots sum in another order)."""
        dims = (32, 32, 32)
        jop, top = _ops(dims)
        b = np.array(jpoisson.rhs_for_exact_ones(jop), np.float32).reshape(dims)
        rj = jkr.cg(jop.mv, jnp.asarray(b), rtol=1e-6, maxiter=50,
                    precond_dot=jmg.mg_preconditioner(jop, return_rdot=True),
                    matvec_dot=jop.mv_dot)
        rt = tkr.cg(top.mv, torch.from_numpy(b), rtol=1e-6, maxiter=50,
                    precond_dot=tmg.mg_preconditioner(top, return_rdot=True),
                    matvec_dot=top.mv_dot)
        assert bool(rt.converged) and rt.x.dtype == torch.float32
        assert abs(rt.iters - int(rj.iters)) <= 1
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                                   atol=1e-6)

    def test_divergence_cutoff(self):
        """An indefinite operator trips divtol and reports not converged."""
        top = tpoisson.poisson3d(8, 8, 8)
        b = torch.from_numpy(_rhs((8, 8, 8), 6))
        r = tkr.cg(lambda v: -3.0 * top.mv(v) + 10.0 * v, b, rtol=1e-12,
                   maxiter=200, divtol=10.0)
        assert not bool(r.converged) and r.iters < 200


class TestBf16Cycle:
    def test_explicit_bf16_cycle_preconditions_cg(self):
        top = tpoisson.poisson3d(16, 16, 16)
        b = tpoisson.rhs_for_exact_ones(top, torch.float32, "cpu")
        M = tmg.mg_preconditioner(top, dtype=torch.bfloat16)
        assert M(b).dtype == torch.float32   # cast back to the input dtype
        res = tkr.cg(top.mv, b, rtol=1e-6, maxiter=60, precond=M)
        assert bool(res.converged) and res.iters <= 20

    def test_auto_threshold(self, monkeypatch):
        top = tpoisson.poisson3d(8, 8, 8)
        b = tpoisson.rhs_for_exact_ones(top, torch.float32, "cpu")
        monkeypatch.setattr(tmg, "_BF16_CYCLE_BYTES", 1)
        z16, d16 = tmg.mg_preconditioner(top, return_rdot=True)(b)
        assert z16.dtype == torch.float32 and d16.dtype == torch.float32
        monkeypatch.setattr(tmg, "_BF16_CYCLE_BYTES", 10**15)
        z32 = tmg.mg_preconditioner(top)(b)
        zexp = tmg.mg_preconditioner(top, dtype=torch.float32)(b)
        torch.testing.assert_close(z32, zexp, rtol=0, atol=0)
        assert not torch.equal(z16, z32)   # the bf16 cycle really ran
