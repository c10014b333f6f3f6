"""Port parity for the 2D multigrid cycle and the linear transfers
(``solvers/multigrid.py`` on a ``Stencil2D``, ``transfers='linear'`` in 2D
and 3D).

In f64 the port's cycle and the JAX package's compute the same
operations up to summation order, so plans are equal, cycles and
transfers agree to rtol 1e-10, and PCG takes exactly the JAX package's
iteration counts.  A stack of 2D grids goes through one cycle as a batch
and gives each grid what it gets alone (the multisplitting strips under
``pc='mg'``).  Inputs are made with numpy from a seed and given to both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov as jkr
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import multigrid as jmg
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov as tkr
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid as tmg

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)


def _ops(dims):
    if len(dims) == 2:
        return jpoisson.poisson2d(*dims), tpoisson.poisson2d(*dims)
    return jpoisson.poisson3d(*dims), tpoisson.poisson3d(*dims)


def _rhs(dims, seed=0):
    return np.random.default_rng(seed).standard_normal(dims)


def _close(t, j, rtol=1e-10):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=1e-12)


class TestPlan:
    @pytest.mark.parametrize("dims", [(64, 64), (32, 48), (2048, 4096),
                                      (8192, 8192), (6, 10), (16, 16, 16)])
    @pytest.mark.parametrize("transfers", ["pwc", "linear"])
    def test_levels_match(self, dims, transfers):
        jop, top = _ops(dims)
        lj = jmg.plan(jop, transfers=transfers)
        lt = tmg.plan(top, transfers=transfers)
        assert lt.dims == lj.dims and lt.transfers == lj.transfers
        assert (lt.diag, lt.off, lt.nu, lt.coarse_iters, lt.cycle) == (
            lj.diag, lj.off, lj.nu, lj.coarse_iters, lj.cycle)
        # the level description crosses over by its fields
        assert convert.mg_levels_from_fields(lj) == lt
        fields = convert.mg_levels_to_fields(lt)
        assert convert.mg_levels_from_fields(fields) == lt
        assert jmg.MGLevels(**dict(fields, dims=tuple(
            tuple(int(n) for n in d) for d in fields["dims"]))) == lj

    def test_max_levels_and_min_size(self):
        jop, top = _ops((64, 64))
        for kw in ({"max_levels": 2}, {"min_size": 16}, {"max_levels": 1}):
            assert tmg.plan(top, **kw).dims == jmg.plan(jop, **kw).dims

    def test_rejects(self):
        top = tpoisson.poisson2d(8, 8)
        with pytest.raises(ValueError, match="transfers"):
            tmg.plan(top, transfers="cubic")
        with pytest.raises(ValueError, match="cycle"):
            tmg.plan(top, cycle="f")
        with pytest.raises(TypeError, match="Stencil2D/Stencil3D"):
            tmg.plan(object())

    def test_omegas_and_bounds_match(self):
        assert tmg._JACOBI_OMEGA == jmg._JACOBI_OMEGA
        for dims in [(4, 4), (8, 32)]:
            np.testing.assert_allclose(tmg._dirichlet_bounds(dims, 4.0, -1.0),
                                       jmg._dirichlet_bounds(dims, 4.0, -1.0),
                                       rtol=1e-15)


class TestTransfers:
    @pytest.mark.parametrize("dims", [(8, 12), (8, 6, 10)])
    def test_pwc_and_linear_match(self, dims):
        coarse = tuple(n // 2 for n in dims)
        r, e = _rhs(dims, 3), _rhs(coarse, 4)
        rt, et = torch.from_numpy(r), torch.from_numpy(e)
        _close(tmg._restrict(rt, dims), jmg._restrict(jnp.asarray(r), dims),
               1e-14)
        np.testing.assert_array_equal(
            tmg._prolong(et, coarse).numpy(),
            np.asarray(jmg._prolong(jnp.asarray(e), coarse)))
        for ax in range(len(dims)):
            _close(tmg._axis_blend(rt, ax), jmg._axis_blend(jnp.asarray(r), ax),
                   1e-14)
        _close(tmg._restrict_lin(rt, dims),
               jmg._restrict_lin(jnp.asarray(r), dims), 1e-13)
        _close(tmg._prolong_lin(et, coarse),
               jmg._prolong_lin(jnp.asarray(e), coarse), 1e-13)

    @pytest.mark.parametrize("dims", [(8, 12), (4, 6, 8)])
    def test_linear_restriction_is_the_prolongations_transpose(self, dims):
        """R = P^T / 2^d: what keeps the cycle a symmetric preconditioner."""
        coarse = tuple(n // 2 for n in dims)
        r, e = torch.from_numpy(_rhs(dims, 5)), torch.from_numpy(_rhs(coarse, 6))
        a = float(torch.sum(tmg._restrict_lin(r, dims) * e))
        b = float(torch.sum(r * tmg._prolong_lin(e, coarse))) / 2 ** len(dims)
        assert abs(a - b) <= 1e-12 * max(abs(a), 1.0)

    def test_a_stack_of_grids_transfers_grid_by_grid(self):
        dims, coarse = (8, 12), (4, 6)
        r, e = torch.from_numpy(_rhs((3, *dims), 7)), torch.from_numpy(
            _rhs((3, *coarse), 8))
        for f, t, d in ((tmg._restrict, r, dims), (tmg._restrict_lin, r, dims),
                        (tmg._prolong, e, coarse), (tmg._prolong_lin, e, coarse)):
            assert torch.equal(f(t, d), torch.stack([f(g, d) for g in t]))


class TestCycleF64:
    @pytest.mark.parametrize("dims", [(32, 32), (16, 64)])
    @pytest.mark.parametrize("cycle,nu,transfers", [
        ("w", 2, "pwc"), ("v", 2, "pwc"), ("w", 1, "pwc"), ("v", 0, "pwc"),
        ("w", 2, "linear"), ("v", 1, "linear")])
    def test_vcycle_2d(self, dims, cycle, nu, transfers):
        jop, top = _ops(dims)
        b = _rhs(dims, dims[1])
        kw = dict(cycle=cycle, nu=nu, transfers=transfers)
        zj = jmg.vcycle(jmg.plan(jop, **kw), jnp.asarray(b))
        zt = tmg.vcycle(tmg.plan(top, **kw), torch.from_numpy(b))
        assert zt.dtype == torch.float64 and tuple(zt.shape) == dims
        _close(zt, zj)

    @pytest.mark.parametrize("cycle,nu", [("w", 2), ("v", 2), ("v", 0)])
    def test_vcycle_3d_linear(self, cycle, nu):
        dims = (16, 16, 16)
        jop, top = _ops(dims)
        b = _rhs(dims, 9)
        kw = dict(cycle=cycle, nu=nu, transfers="linear")
        zj = jmg.vcycle(jmg.plan(jop, **kw), jnp.asarray(b))
        zt = tmg.vcycle(tmg.plan(top, **kw), torch.from_numpy(b))
        _close(zt, zj)

    @pytest.mark.parametrize("transfers", ["pwc", "linear"])
    def test_preconditioner_2d(self, transfers):
        dims = (32, 32)
        jop, top = _ops(dims)
        r = _rhs(dims, 10).reshape(-1)
        zj = jmg.mg_preconditioner(jop, transfers=transfers)(jnp.asarray(r))
        zt = tmg.mg_preconditioner(top, transfers=transfers)(torch.from_numpy(r))
        assert tuple(zt.shape) == r.shape
        _close(zt, zj)
        # return_rdot: Stencil2D has no fused last sweep, so the dot is the
        # explicit f32 one in both packages
        zdj, dj = jmg.mg_preconditioner(jop, transfers=transfers,
                                        return_rdot=True)(jnp.asarray(r))
        zdt, dt_ = tmg.mg_preconditioner(top, transfers=transfers,
                                         return_rdot=True)(
            torch.from_numpy(r).reshape(dims))
        _close(zdt.reshape(-1), zdj)
        np.testing.assert_allclose(float(dt_), float(dj), rtol=1e-5)

    def test_reduced_precision_cycle_2d(self):
        """A bf16 cycle on an f32 residual: the correction comes back in
        f32 and, as a preconditioner needs, within a few percent of the
        f32 cycle's in norm."""
        top = tpoisson.poisson2d(32, 32)
        r = torch.from_numpy(_rhs((32, 32), 11)).float()
        z32 = tmg.mg_preconditioner(top)(r)
        z16 = tmg.mg_preconditioner(top, dtype=torch.bfloat16)(r)
        assert z16.dtype == torch.float32 and tuple(z16.shape) == (32, 32)
        rel = float(torch.linalg.vector_norm(z16 - z32)
                    / torch.linalg.vector_norm(z32))
        assert rel < 0.05, rel

    def test_bf16_v_cycle_degrades_in_both_packages(self):
        """In 2D the sweeps outside the apply round every operation to
        bf16 and ``b - A x`` cancels: PCG with a bf16 V-cycle takes more
        iterations than with an f32 one, in the JAX package and in the
        port (which rounds the apply once, and is no worse)."""
        n = 192
        jop, top = _ops((n, n))
        b = np.asarray(jop.mv(jnp.ones((n, n), jnp.float32)))
        b = b / np.linalg.norm(b)
        iters = {}
        for name, jd, td in (("f32", jnp.float32, torch.float32),
                             ("bf16", jnp.bfloat16, torch.bfloat16)):
            Mj = jmg.mg_preconditioner(jop, cycle="v", dtype=jd)
            Mt = tmg.mg_preconditioner(top, cycle="v", dtype=td)
            rj = jkr.cg(jop.mv, jnp.asarray(b), rtol=1e-4, maxiter=40,
                        precond=Mj)
            rt = tkr.cg(top.mv, torch.from_numpy(b.copy()), rtol=1e-4,
                        maxiter=40, precond=Mt)
            assert bool(rj.converged) and bool(rt.converged)
            iters[name] = (int(rj.iters), rt.iters)
        assert iters["f32"][0] == iters["f32"][1]
        assert iters["bf16"][0] > iters["f32"][0]
        assert iters["f32"][1] < iters["bf16"][1] <= iters["bf16"][0]

    def test_symmetric_2d(self):
        for transfers in ("pwc", "linear"):
            M = tmg.mg_preconditioner(tpoisson.poisson2d(16, 16),
                                      transfers=transfers)
            u = torch.from_numpy(_rhs((256,), 1))
            v = torch.from_numpy(_rhs((256,), 2))
            a, b = float(torch.dot(M(u), v)), float(torch.dot(u, M(v)))
            assert abs(a - b) < 1e-10 * max(abs(a), 1.0)

    @pytest.mark.parametrize("flat", [False, True])
    def test_a_stack_of_grids_is_a_batch(self, flat):
        """The strips of multisplitting: ``M`` on a stack gives each grid
        the correction it gets alone."""
        dims = (16, 32)
        M = tmg.mg_preconditioner(tpoisson.poisson2d(*dims))
        r = torch.from_numpy(_rhs((3, *dims), 12))
        if flat:
            r = r.reshape(3, -1)
        z = M(r)
        assert z.shape == r.shape
        for i in range(3):
            torch.testing.assert_close(z[i], M(r[i]), rtol=1e-13, atol=1e-13)


class TestPCG:
    @pytest.mark.parametrize("dims,transfers,cycle", [
        ((32, 32), "pwc", "w"), ((64, 64), "pwc", "w"), ((64, 64), "pwc", "v"),
        ((32, 64), "linear", "w"), ((16, 16, 16), "linear", "v")])
    def test_iteration_counts_equal(self, dims, transfers, cycle):
        jop, top = _ops(dims)
        b = np.asarray(jop.mv(jnp.ones(dims)))
        Mj = jmg.mg_preconditioner(jop, transfers=transfers, cycle=cycle)
        Mt = tmg.mg_preconditioner(top, transfers=transfers, cycle=cycle)
        rj = jkr.cg(jop.mv, jnp.asarray(b), rtol=1e-8, maxiter=100, precond=Mj)
        rt = tkr.cg(top.mv, torch.from_numpy(b), rtol=1e-8, maxiter=100,
                    precond=Mt)
        assert bool(rt.converged) and rt.iters == int(rj.iters)
        assert rt.iters <= 15   # grid-independent, far below plain CG
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                                   atol=1e-12)

    def test_batched_pcg_on_strips(self):
        """Batched ``cg`` with the batched cycle: each strip takes the
        iterations it takes alone."""
        dims = (16, 32)
        top = tpoisson.poisson2d(*dims)
        M = tmg.mg_preconditioner(top)
        b = torch.stack([top.mv(torch.from_numpy(_rhs(dims, s)).reshape(-1))
                         for s in (20, 21)])
        res = tkr.cg(top.mv, b, rtol=1e-8, maxiter=100, precond=M, batched=True)
        for i in range(2):
            one = tkr.cg(top.mv, b[i], rtol=1e-8, maxiter=100, precond=M)
            assert int(res.iters[i]) == one.iters and bool(res.converged[i])
            torch.testing.assert_close(res.x[i], one.x, rtol=1e-10, atol=1e-12)
