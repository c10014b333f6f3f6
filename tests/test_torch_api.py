"""Port parity for the one-call API (``api.py``: ``solve``, ``prepare``,
``PreparedSolver``, ``lstsq``) and the solvers only it reaches:
``solvers/bjacobi.py``, ``solvers/eigest.py``, ``solvers/castep.py`` and
``solvers/amg.py``.

The same scipy matrices, made with numpy from a seed, go through both
packages in f64 on the CPU, with the port's calibration table set to the
JAX package's shipped values so that both route alike.  ``operator``,
``method``, ``pc`` and ``iters`` must be equal; x agrees to 1e-8 (the two
run their sums in different orders; relative to the largest entry), the
preconditioner applies to 1e-13.  Bad arguments raise the same
``ValueError``s.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import medane_tchakorom_ufc_thesis_repository_tpu as jpkg
import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
from medane_tchakorom_ufc_thesis_repository_tpu.core import calibration as jcal
from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import amg as jamg
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import bjacobi as jbj
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import castep as jca
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import eigest as jeig
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov as jkr
from medane_tchakorom_ufc_thesis_repository_tpu_torch import api as tapi
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import calibration as tcal
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import amg as tamg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import bjacobi as tbj
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import castep as tca
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import eigest as teig

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

CPU = "cpu"
J64 = dict(dtype=jnp.float64)
T64 = dict(dtype=torch.float64, device=CPU)


@pytest.fixture(autouse=True)
def jax_table(monkeypatch):
    """Route with the JAX package's shipped constants in both packages."""
    monkeypatch.delenv("MEDANE_TORCH_CALIBRATION", raising=False)
    monkeypatch.setattr(tcal, "_loaded", {
        k: (dict(v) if isinstance(v, dict) else v)
        for k, v in jcal.SHIPPED.items()})


def _spd_blockable(nb=16, bs=16, seed=71):
    """``tests/test_api.py``'s matrix: SPD diagonal blocks with a spectrum
    of 1 to 100 plus a weak random symmetric coupling."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    A = sp.lil_matrix((n, n))
    for k in range(nb):
        Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
        A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = (
            (Q * np.logspace(0, 2, bs)) @ Q.T)
    C = sp.random(n, n, density=0.02, random_state=seed + 1)
    return (A.tocsr() + 1e-2 * (C + C.T)).tocsr()


def _poisson(m=20, n=20, convection=0.0):
    rows, cols, vals, shape = jpoisson.poisson2d_coo(m, n)
    vals = vals.copy()
    vals[cols == rows + 1] += convection
    vals[cols == rows - 1] -= convection
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def _rhs(A, k=None):
    n = A.shape[0]
    b = np.asarray(A @ np.ones(n))
    if k is None:
        return b
    rng = np.random.default_rng(7)
    return np.stack([b] + [rng.standard_normal(n) for _ in range(k - 1)],
                    axis=1)


def _same(A, b, x_tol=1e-8, **kw):
    xj, ij = jpkg.solve(A, b, **J64, **kw)
    xt, it = port.solve(A, b, **T64, **kw)
    for key in ("operator", "method", "pc", "converged"):
        assert it[key] == ij[key], key
    np.testing.assert_array_equal(np.asarray(it["iters"]),
                                  np.asarray(ij["iters"]))
    assert xt.dtype == np.float64 and xt.shape == xj.shape
    assert np.abs(xt - xj).max() <= x_tol * np.abs(xj).max()
    # the final norms sit near the rounding floor: 1e-3 there, the
    # starting norm to 1e-10
    for key in ("rel_residual", "resnorm"):
        np.testing.assert_allclose(it[key], ij[key], rtol=1e-3, atol=1e-14)
    np.testing.assert_allclose(it["resnorm0"], ij["resnorm0"], rtol=1e-10)
    assert set(it) == set(ij)
    return it


class TestSolve:
    def test_gmres_bjacobi_on_the_blockable_matrix(self):
        A = _spd_blockable()
        it = _same(A, _rhs(A), rtol=1e-8, pc="bjacobi", pc_block_size=16)
        assert (it["operator"], it["method"], it["pc"]) == (
            "BSR", "gmres", "bjacobi")
        assert it["converged"] and it["rel_residual"] <= 1.1e-8
        assert it["iters"] < 10

    def test_gmres_plain_and_ca_gmres(self):
        A = _spd_blockable()
        plain = _same(A, _rhs(A), rtol=1e-8)
        assert plain["iters"] > 30
        ca = _same(A, _rhs(A), rtol=1e-8, method="ca_gmres", s=6)
        assert ca["method"] == "ca_gmres" and ca["converged"]

    def test_cg_jacobi_on_poisson_routes_dia(self):
        A = _poisson()
        it = _same(A, _rhs(A), rtol=1e-9, method="cg", pc="jacobi",
                   assume_a="pos")
        assert it["operator"] == "DIA" and it["converged"]

    def test_auto_picks_minres_and_jacobi(self):
        A = _poisson()
        it = _same(A, _rhs(A), rtol=1e-9, method="auto", pc="auto")
        assert (it["method"], it["pc"]) == ("minres", "jacobi")
        An = _poisson(convection=0.4)
        it = _same(An, _rhs(An), rtol=1e-9, method="auto", pc="auto")
        assert (it["method"], it["pc"]) == ("gmres", "jacobi")
        ip = _same(A, _rhs(A), rtol=1e-9, method="auto", assume_a="pos")
        assert ip["method"] == "cg"

    def test_auto_pc_is_bjacobi_on_a_bsr_route(self):
        A = _spd_blockable(seed=77)
        An = (A + sp.random(A.shape[0], A.shape[0], density=0.01,
                            random_state=9) * 1e-2).tocsr()
        it = _same(An, _rhs(An), rtol=1e-8, method="auto", pc="auto")
        assert (it["method"], it["operator"], it["pc"]) == (
            "gmres", "BSR", "bjacobi")

    def test_bicgstab_with_a_start(self):
        A = _poisson(convection=0.4)
        x0 = 0.1 * np.random.default_rng(3).standard_normal(A.shape[0])
        it = _same(A, _rhs(A), rtol=1e-9, method="bicgstab", pc="jacobi",
                   x0=x0)
        assert it["converged"]

    @pytest.mark.parametrize("kw", [
        dict(method="gmres", pc="bjacobi", pc_block_size=16),
        dict(method="gmres"),
        dict(method="cg", pc="jacobi"),
        dict(method="minres"),
        dict(method="bicgstab", pc="jacobi")])
    def test_panel_of_right_hand_sides(self, kw):
        A = _spd_blockable() if "pc_block_size" in kw else _poisson(
            convection=0.4 if kw["method"] in ("bicgstab", "gmres") else 0.0)
        B = _rhs(A, 3)
        it = _same(A, B, rtol=1e-8, **kw)
        assert it["converged"] and it["converged_per_rhs"].all()
        assert it["iters"].shape == (3,) and it["rel_residual"].shape == (3,)
        assert (it["rel_residual"] <= 2e-8).all()

    def test_amg_preconditioned_cg(self):
        A = _poisson(28, 28)
        it = _same(A, _rhs(A), rtol=1e-9, method="cg", pc="amg")
        assert it["pc"] == "amg" and it["converged"] and it["iters"] < 30

    def test_f32_default_dtype(self):
        A = _poisson(24, 24)
        x, info = port.solve(A, _rhs(A), rtol=1e-5, device=CPU)
        assert info["converged"] and info["operator"] == "DIA"
        assert info["rel_residual"] <= 2e-5

    def test_validation(self):
        A = _spd_blockable(nb=2, bs=8)
        b = np.ones(A.shape[0])
        bad = [
            ("method", lambda s: s(A, b, method="sor")),
            ("pc", lambda s: s(A, b, pc="ilu")),
            ("assume_a", lambda s: s(A, b, assume_a="spd")),
            ("square", lambda s: s(sp.random(8, 12, density=0.5),
                                   np.ones(8))),
            ("length", lambda s: s(A, np.ones(3))),
            ("compose", lambda s: s(A, b, method="ca_gmres", pc="bjacobi")),
            ("single RHS", lambda s: s(A, np.ones((A.shape[0], 2)),
                                       method="ca_gmres")),
        ]
        for match, call in bad:
            with pytest.raises(ValueError, match=match) as ej:
                call(jpkg.solve)
            with pytest.raises(ValueError, match=match) as et:
                call(lambda *a, **k: port.solve(*a, device=CPU, **k))
            assert str(et.value) == str(ej.value)

    def test_no_card_no_default(self):
        A = _poisson(4, 4)
        for call in (lambda: port.solve(A, np.ones(16)),
                     lambda: port.prepare(A),
                     lambda: port.lstsq(A, np.ones(16))):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()


class TestPrepare:
    def test_handle_reuses_routing_and_preconditioner(self):
        A = _spd_blockable()
        jprep = jpkg.prepare(A, rtol=1e-8, pc="bjacobi", pc_block_size=16,
                             **J64)
        tprep = port.prepare(A, rtol=1e-8, pc="bjacobi", pc_block_size=16,
                             **T64)
        assert isinstance(tprep, port.PreparedSolver)
        assert tprep.operator == jprep.operator == "BSR"
        assert (tprep.method, tprep.pc) == (jprep.method, jprep.pc)
        B = _rhs(A, 3)
        for b in (B[:, 0], B[:, 1], B):
            xj, ij = jprep.solve(b)
            xt, it = tprep.solve(b)
            np.testing.assert_array_equal(np.asarray(it["iters"]),
                                          np.asarray(ij["iters"]))
            assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()
        # right-preconditioned GMRES starts from zero in both packages
        x0 = np.ones(A.shape[0])
        _, ij = jprep.solve(B[:, 0], x0=x0)
        _, it = tprep.solve(B[:, 0], x0=x0)
        assert it["iters"] == ij["iters"] and it["converged"]

    def test_is_symmetric(self):
        A = _poisson(6, 6)
        assert tapi.is_symmetric(A) and jpkg.is_symmetric(A)
        An = _poisson(6, 6, convection=0.1)
        assert not tapi.is_symmetric(An) and not jpkg.is_symmetric(An)
        assert tapi.is_symmetric(sp.csr_matrix((4, 4)))


class TestLstsq:
    def _system(self):
        R = (sp.random(300, 120, density=0.05, random_state=4)
             + sp.eye(300, 120)).tocsr()
        b = np.asarray(R @ np.ones(120)) + 0.01 * np.random.default_rng(
            3).standard_normal(300)
        return R, b

    @pytest.mark.parametrize("method", ["lsqr", "cgne", "qr"])
    def test_methods_match_jax(self, method):
        R, b = self._system()
        xj, ij = jpkg.lstsq(R, b, method=method, rtol=1e-10, **J64)
        xt, it = port.lstsq(R, b, method=method, rtol=1e-10, **T64)
        assert set(it) == set(ij)
        for key in ("operator", "method", "iters", "converged"):
            assert it[key] == ij[key], key
        assert it.get("resnorm_scale") == ij.get("resnorm_scale")
        assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()
        assert it["rel_opt"] <= 1e-9
        np.testing.assert_allclose(it["rel_residual"], ij["rel_residual"],
                                   rtol=1e-8)

    def test_large_route_is_aij_and_uses_rmv(self, monkeypatch):
        R, b = self._system()
        monkeypatch.setitem(tcal._loaded, "max_dense_n", 0)
        x0 = np.full(120, 0.5)
        xt, it = port.lstsq(R, b, rtol=1e-10, x0=x0, **T64)
        assert it["operator"] == "AIJ" and it["converged"]
        xd, _ = np.linalg.lstsq(R.toarray(), b, rcond=None)[:2]
        assert np.abs(xt - xd).max() <= 1e-8
        xq, iq = port.lstsq(R, b, method="qr", **T64)
        assert iq["operator"] == "AIJ" and np.abs(xq - xd).max() <= 1e-10

    def test_validation(self):
        R, b = self._system()
        wide = sp.random(8, 12, density=0.5, random_state=1).tocsr()
        for match, call in (
                ("method", lambda f: f(R, b, method="svd")),
                ("length", lambda f: f(R, b[:5])),
                ("m >= n", lambda f: f(wide, np.ones(8), method="qr"))):
            with pytest.raises(ValueError, match=match) as ej:
                call(jpkg.lstsq)
            with pytest.raises(ValueError, match=match) as et:
                call(lambda *a, **k: port.lstsq(*a, device=CPU, **k))
            assert str(et.value) == str(ej.value)
        big = sp.eye(9000, 8000, format="csr")
        with pytest.raises(ValueError, match="densifies"):
            port.lstsq(big, np.ones(9000), method="qr", device=CPU)


class TestBlockJacobi:
    @pytest.mark.parametrize("n,bs", [(96, 16), (100, 16), (64, 64)])
    def test_setup_and_apply_match_jax(self, n, bs):
        A = (sp.random(n, n, density=0.1, random_state=5)
             + sp.eye(n) * 4).tocsr()
        jp_ = jbj.block_jacobi_from_scipy(A, bs=bs, **J64)
        tp_ = tbj.block_jacobi_from_scipy(A, bs=bs, **T64)
        assert (tp_.n, tp_.bs) == (jp_.n, jp_.bs)
        np.testing.assert_array_equal(tp_.inv_blocks.numpy(),
                                      np.asarray(jp_.inv_blocks))
        r = np.random.default_rng(6).standard_normal((3, n))
        want = np.stack([np.asarray(jp_.apply(jnp.asarray(v))) for v in r])
        got = tp_(torch.from_numpy(r)).numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
        one = tp_.apply(torch.from_numpy(r[0])).numpy()
        assert np.abs(one - want[0]).max() <= 1e-13 * np.abs(want).max()
        moved = convert.block_jacobi_from_jax(jp_, device=CPU)
        np.testing.assert_array_equal(moved.inv_blocks.numpy(),
                                      tp_.inv_blocks.numpy())

    def test_singular_block_gets_its_pseudo_inverse(self):
        rows = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8])
        cols = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0])
        vals = np.array([1.0, 2, 0, 4, 5, 6, 7, 8, 3])   # A[2, 2] = 0
        jp_ = jbj.block_jacobi_from_coo(rows, cols, vals, 9, bs=4, **J64)
        tp_ = tbj.block_jacobi_from_coo(rows, cols, vals, 9, bs=4, **T64)
        np.testing.assert_allclose(tp_.inv_blocks.numpy(),
                                   np.asarray(jp_.inv_blocks), atol=1e-15)
        # the last block holds row 8's zero diagonal and the identity tail
        assert tp_.inv_blocks[2].diagonal().tolist() == [0.0, 1.0, 1.0, 1.0]
        with pytest.raises(ValueError, match="positive"):
            tbj.block_jacobi_from_coo(rows, cols, vals, 0, device=CPU)
        with pytest.raises(ValueError, match="square"):
            tbj.block_jacobi_from_scipy(sp.eye(3, 4), device=CPU)


class TestEigestAndCaGmres:
    def test_lanczos_coefficients_and_bounds(self):
        jop = jpoisson.poisson2d_dia(12, 12, **J64)
        top = tpoisson.poisson2d_dia(12, 12, **T64)
        v0 = np.random.default_rng(1).standard_normal(144)
        v0 /= np.linalg.norm(v0)
        ja, jb = jeig.lanczos_coeffs(jop.mv, jnp.asarray(v0), 20)
        ta, tb = teig.lanczos_coeffs(top.mv, torch.from_numpy(v0), 20)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-9)
        assert teig.bounds_from_coeffs(ja, jb) == jeig.bounds_from_coeffs(
            ja, jb)
        lj = jeig.lanczos_bounds(jop.mv, 144, **J64)
        lt = teig.lanczos_bounds(top.mv, 144, **T64)
        np.testing.assert_allclose(lt, lj, rtol=1e-9)
        # an identity breaks down at once: the interval is exact
        assert teig.lanczos_bounds(lambda v: 3.0 * v, 50, **T64) == \
            pytest.approx((2.7, 3.3), rel=1e-12)
        with pytest.raises(ValueError, match="not positive"):
            teig.lanczos_bounds(lambda v: -v, 50, **T64)

    @pytest.mark.parametrize("reductions", ["column", "single"])
    def test_ca_gmres_matches_jax(self, reductions):
        jop = jpoisson.poisson2d_dia(12, 12, **J64)
        top = tpoisson.poisson2d_dia(12, 12, **T64)
        b = np.asarray(jop.mv(jnp.ones(144)))
        kw = dict(s=6, maxiter=600, rtol=1e-8, lmin=0.05, lmax=8.0,
                  reductions=reductions)
        assert tca.chebyshev_shifts(0.05, 8.0, 6) == jca.chebyshev_shifts(
            0.05, 8.0, 6)
        rj = jca.ca_gmres(jop.mv, jnp.asarray(b), **kw)
        rt = tca.ca_gmres(top.mv, torch.from_numpy(b), **kw)
        assert int(rt.iters) == int(rj.iters) and bool(rt.converged)
        assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() <= 1e-8
        fixed = tca.ca_gmres(top.mv, torch.from_numpy(b), fixed_cycles=True,
                             **{**kw, "maxiter": int(rj.iters)})
        np.testing.assert_array_equal(fixed.x.numpy(), rt.x.numpy())
        assert fixed.syncs == 0
        with pytest.raises(ValueError, match="reductions"):
            tca.ca_gmres(top.mv, torch.from_numpy(b), reductions="none")
        # the same Krylov space per cycle as GMRES(s)
        rg = jkr.gmres(jop.mv, jnp.asarray(b), restart=6, maxiter=600,
                       rtol=1e-8)
        assert abs(int(rt.iters) - int(rg.iters)) <= 6


class TestAmg:
    def test_hierarchy_and_cycle_match_jax(self):
        A = _poisson(28, 28)
        jm = jamg.amg_setup(A, nu=2, **J64)
        tm = tamg.amg_setup(A, nu=2, **T64)
        assert len(tm.levels) == len(jm.levels) >= 1
        for jl, tl in zip(jm.levels, tm.levels):
            assert type(tl.op).__name__ == type(jl.op).__name__
            np.testing.assert_allclose(tl.dinv.numpy(), np.asarray(jl.dinv),
                                       rtol=1e-15)
            np.testing.assert_array_equal(tl.P.indices.numpy(),
                                          np.asarray(jl.P.indices))
            np.testing.assert_allclose(tl.Pt.values.numpy(),
                                       np.asarray(jl.Pt.values), rtol=1e-15)
        np.testing.assert_allclose(tm.coarse_inv.numpy(),
                                   np.asarray(jm.coarse_inv), rtol=1e-12,
                                   atol=1e-14)
        r = np.random.default_rng(2).standard_normal((2, A.shape[0]))
        want = np.stack([np.asarray(jm.apply(jnp.asarray(v))) for v in r])
        got = tm.apply(torch.from_numpy(r)).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

    def test_refuses_what_it_cannot_coarsen(self):
        with pytest.raises(ValueError, match="square"):
            tamg.amg_setup(sp.eye(3, 4), device=CPU)
        with pytest.raises(ValueError, match="stalled"):
            tamg.amg_setup(sp.eye(600, format="csr"), max_coarse_dense=100,
                           device=CPU)


class TestConvertResults:
    def test_krylov_result_round_trip(self):
        jop = jpoisson.poisson2d_dia(8, 8, **J64)
        rj = jkr.cg(jop.mv, jop.mv(jnp.ones(64)), rtol=1e-10)
        fields = {f: np.asarray(getattr(rj, f))
                  for f in ("x", "iters", "resnorm", "resnorm0", "converged")}
        rt = convert.krylov_result_from_numpy(fields, device=CPU)
        assert int(rt.iters) == int(rj.iters) and bool(rt.converged)
        back = convert.krylov_result_to_numpy(rt)
        np.testing.assert_array_equal(back["x"], fields["x"])
        assert back["syncs"] == 0
