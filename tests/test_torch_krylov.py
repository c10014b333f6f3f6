"""Port parity for the inner and outer solvers of the multisplitting
slice: batched GMRES (``solvers/krylov.py``), Chebyshev with a start
(``solvers/chebyshev.py``), the tall-skinny least squares
(``solvers/lstsq.py``) and LSQR/CGNE (``solvers/lsqr.py``).

Every case runs the JAX function and its port on the same inputs, made
with numpy from a seed, in f64 on the CPU (the port's kernels take their
plain versions there).  Iteration counts must be equal; iterates agree
to 1e-10 (GMRES, whose Gram-Schmidt sums run in another order than XLA's
``dot_general``) or 1e-12 (the rest), relative to the largest entry.
A batch of systems is held against ``jax.vmap`` of the JAX solver, which
freezes each system once its own loop test fails.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov as jkr
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
    chebyshev as jchebyshev,
    poisson_strip_eig_bounds_2d,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lsqr import (
    cgne as jcgne,
    lsqr as jlsqr,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lstsq import (
    lstsq_normal as jlstsq_normal,
    lstsq_qr as jlstsq_qr,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as k2
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov as tkr
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    chebyshev as tchebyshev,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lsqr import (
    cgne as tcgne,
    lsqr as tlsqr,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    lstsq_normal as tlstsq_normal,
    lstsq_qr as tlstsq_qr,
)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(t, ref, rtol):
    got = t.to(torch.float64).numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, err


def _batched_mv(m, n):
    """``A x`` for every row of a ``(batch, m*n)`` array (the port)."""
    def mv(v):
        return k2.stencil2d_apply(v.reshape(-1, m, n), diag=4.0,
                                  off=-1.0).reshape(v.shape)
    return mv


class TestGmres:
    def test_golden_103(self):
        """``tests/test_golden.py:55-59`` in both packages."""
        jop, top = jpoisson.poisson2d(32, 32), tpoisson.poisson2d(32, 32)
        b = np.asarray(jpoisson.rhs_for_exact_ones(jop), np.float64)
        rj = jkr.gmres(jop.mv, jnp.asarray(b), restart=30, maxiter=2000,
                       rtol=1e-6)
        rt = tkr.gmres(top.mv, torch.from_numpy(b), restart=30, maxiter=2000,
                       rtol=1e-6)
        assert int(rt.iters) == int(rj.iters) == 103
        assert bool(rt.converged) and bool(rj.converged)
        _close(rt.x, rj.x, 1e-10)
        np.testing.assert_allclose(float(rt.resnorm), float(rj.resnorm),
                                   rtol=1e-6)
        # one host read before each restart cycle after the first, and
        # the one that finds every system done
        assert rt.syncs == math.ceil(103 / 30)

    def test_batch_freezes_each_system(self):
        """Two different systems in one batch: each takes its own count,
        as under ``jax.vmap`` of the JAX solver."""
        m = n = 16
        jop = jpoisson.poisson2d(m, n)
        B = np.stack([np.asarray(jpoisson.rhs_for_exact_ones(jop)),
                      _np(m * n, 1)])
        X0 = np.stack([np.zeros(m * n), _np(m * n, 2)])
        kw = dict(restart=10, maxiter=400, rtol=1e-8)
        rj = jax.vmap(lambda b, x0: jkr.gmres(jop.mv, b, x0, **kw))(
            jnp.asarray(B), jnp.asarray(X0))
        rt = tkr.gmres(_batched_mv(m, n), torch.from_numpy(B),
                       torch.from_numpy(X0), **kw)
        it_j, it_t = np.asarray(rj.iters), rt.iters.numpy()
        np.testing.assert_array_equal(it_t, it_j)
        assert it_t[0] != it_t[1]
        assert rt.converged.all() and np.asarray(rj.converged).all()
        _close(rt.x, rj.x, 1e-10)
        _close(rt.resnorm, rj.resnorm, 1e-6)
        _close(rt.resnorm0, rj.resnorm0, 1e-12)

    @pytest.mark.parametrize("case", [
        "cgs", "fixed_cycles", "stag_tol", "atol_and_rnorm0",
        "maxiter_below_restart", "divtol"])
    def test_options(self, case):
        m = n = 12
        jop, top = jpoisson.poisson2d(m, n), tpoisson.poisson2d(m, n)
        b = _np(m * n, 3)
        kw = dict(restart=8, maxiter=200, rtol=1e-9)
        x0 = None
        mv_j, mv_t = jop.mv, top.mv
        if case == "cgs":
            kw["orthog"] = "cgs"
        elif case == "fixed_cycles":
            kw.update(fixed_cycles=True, maxiter=40)
        elif case == "stag_tol":
            kw.update(stag_tol=0.5, rtol=1e-14)
        elif case == "atol_and_rnorm0":
            kw.update(atol=1e-6, rtol=0.0, rnorm0=10.0)
            x0 = _np(m * n, 4)
        elif case == "maxiter_below_restart":
            kw.update(restart=30, maxiter=7)
        elif case == "divtol":
            # a negated operator drives the residual up
            kw.update(divtol=2.0, restart=4)
            x0 = 1e3 * _np(m * n, 5)
            mv_j = lambda v: -jop.mv(v) + 3.0 * v   # noqa: E731
            mv_t = lambda v: -top.mv(v) + 3.0 * v   # noqa: E731
        rj = jkr.gmres(mv_j, jnp.asarray(b),
                       None if x0 is None else jnp.asarray(x0), **kw)
        rt = tkr.gmres(mv_t, torch.from_numpy(b),
                       None if x0 is None else torch.from_numpy(x0), **kw)
        assert int(rt.iters) == int(rj.iters)
        assert bool(rt.converged) == bool(rj.converged)
        _close(rt.x, rj.x, 1e-10)

    @pytest.mark.parametrize("orthog", ["cgs", "cgs2"])
    @pytest.mark.parametrize("dtype", ["f64", "f32"])
    def test_bf16_basis(self, dtype, orthog):
        """A bf16 basis, its dots summed in the problem's type.  In f64 the
        two packages round the same basis values and agree to 1e-10.  In
        f32, as the card runs the thesis path, the sums' order moves the
        rounding, and at tight tolerances the bf16 basis turns that into
        a few iterations either way; at the inner solves' rtol 1e-3 the
        counts are equal and the iterates agree to 1e-5."""
        m = n = 16
        jop, top = jpoisson.poisson2d(m, n), tpoisson.poisson2d(m, n)
        npd = {"f64": np.float64, "f32": np.float32}[dtype]
        b = np.asarray(jpoisson.rhs_for_exact_ones(jop), npd)
        kw = dict(restart=20, maxiter=400, orthog=orthog,
                  rtol=1e-6 if dtype == "f64" else 1e-3)
        rj = jkr.gmres(jop.mv, jnp.asarray(b), basis_dtype=jnp.bfloat16, **kw)
        rt = tkr.gmres(top.mv, torch.from_numpy(b),
                       basis_dtype=torch.bfloat16, **kw)
        assert rt.x.dtype == torch.from_numpy(b).dtype
        assert int(rt.iters) == int(rj.iters)
        _close(rt.x, rj.x, 1e-10 if dtype == "f64" else 1e-5)

    def test_rejects_unknown_orthog(self):
        with pytest.raises(ValueError):
            tkr.gmres(lambda v: v, torch.ones(4), orthog="mgs")


class TestChebyshev:
    def test_from_a_start(self):
        """``x0``: ``r0 = b - A x0`` and the loop starts from ``x0``."""
        m = n = 10
        jop, top = jpoisson.poisson2d(m, n), tpoisson.poisson2d(m, n)
        lo, hi = poisson_strip_eig_bounds_2d(m, n)
        b, x0 = _np(m * n, 6), _np(m * n, 7)
        rj = jchebyshev(jop.mv, jnp.asarray(b), jnp.asarray(x0), lmin=lo,
                        lmax=hi, maxiter=15)
        rt = tchebyshev(top.mv, torch.from_numpy(b), torch.from_numpy(x0),
                        lmin=lo, lmax=hi, maxiter=15)
        _close(rt.x, rj.x, 1e-12)
        np.testing.assert_allclose(float(rt.resnorm0), float(rj.resnorm0),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(rt.resnorm), float(rj.resnorm),
                                   rtol=1e-10)
        # a start changes the answer
        r0 = tchebyshev(top.mv, torch.from_numpy(b), lmin=lo, lmax=hi,
                        maxiter=15)
        assert not torch.allclose(r0.x, rt.x)

    def test_batched(self):
        m = n = 8
        jop = jpoisson.poisson2d(m, n)
        lo, hi = poisson_strip_eig_bounds_2d(m, n)
        B, X0 = _np((3, m * n), 8), _np((3, m * n), 9)
        rj = jax.vmap(lambda b, x: jchebyshev(jop.mv, b, x, lmin=lo, lmax=hi,
                                              maxiter=12, rtol=1e-3))(
            jnp.asarray(B), jnp.asarray(X0))
        rt = tchebyshev(_batched_mv(m, n), torch.from_numpy(B),
                        torch.from_numpy(X0), lmin=lo, lmax=hi, maxiter=12,
                        rtol=1e-3, batched=True)
        _close(rt.x, rj.x, 1e-12)
        _close(rt.resnorm, rj.resnorm, 1e-10)
        np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
        np.testing.assert_array_equal(rt.converged.numpy(),
                                      np.asarray(rj.converged))


class TestLeastSquares:
    @pytest.mark.parametrize("batch", [False, True])
    @pytest.mark.parametrize("method", ["qr", "normal", "normal_damped"])
    def test_direct(self, method, batch):
        R, rhs = _np((3, 200, 6), 10), _np((3, 200), 11)
        R[:, :, 5] = R[:, :, 4] + 1e-2 * R[:, :, 5]   # a near-dependent pair
        if method == "qr":
            fj, ft = jlstsq_qr, tlstsq_qr
        else:
            l2 = 1e-3 if method == "normal_damped" else 0.0
            fj = lambda a, b: jlstsq_normal(a, b, l2=l2)   # noqa: E731
            ft = lambda a, b: tlstsq_normal(a, b, l2=l2)   # noqa: E731
        if batch:
            aj = np.stack([np.asarray(fj(jnp.asarray(R[i]), jnp.asarray(rhs[i])))
                           for i in range(3)])
            at = ft(torch.from_numpy(R), torch.from_numpy(rhs))
        else:
            aj = np.asarray(fj(jnp.asarray(R[0]), jnp.asarray(rhs[0])))
            at = ft(torch.from_numpy(R[0]), torch.from_numpy(rhs[0]))
        # the Gram matrix squares the pair's conditioning (~1e4)
        _close(at, aj, 1e-10)

    @pytest.mark.parametrize("method", ["lsqr", "lsqr_x0", "cgne"])
    def test_iterative(self, method):
        R, rhs = _np((120, 5), 12), _np(120, 13)
        Rj, Rt = jnp.asarray(R), torch.from_numpy(R)
        kw = dict(maxiter=70, rtol=1e-10)
        if method == "cgne":
            rj = jcgne(lambda a: Rj @ a, lambda u: Rj.T @ u, jnp.asarray(rhs),
                       n=5, **kw)
            rt = tcgne(lambda a: Rt @ a, lambda u: Rt.T @ u,
                       torch.from_numpy(rhs), **kw)
        else:
            x0 = _np(5, 14) if method == "lsqr_x0" else None
            rj = jlsqr(lambda a: Rj @ a, lambda u: Rj.T @ u, jnp.asarray(rhs),
                       None if x0 is None else jnp.asarray(x0), n=5, **kw)
            rt = tlsqr(lambda a: Rt @ a, lambda u: Rt.T @ u,
                       torch.from_numpy(rhs),
                       None if x0 is None else torch.from_numpy(x0), n=5, **kw)
        assert rt.iters == int(rj.iters)
        assert bool(rt.converged) == bool(rj.converged)
        assert rt.syncs == rt.iters + 1 or rt.iters == kw["maxiter"]
        _close(rt.x, rj.x, 1e-12)
        np.testing.assert_allclose(
            rt.x.numpy(), np.linalg.lstsq(R, rhs, rcond=None)[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# Slice 3: cg with a start, minres, bicgstab; one system and a batch
# ---------------------------------------------------------------------------

def _dia_pair(rows, cols, vals, shape):
    return (jpoisson.coo_to_dia(rows, cols, vals, shape, dtype=jnp.float64),
            tpoisson.coo_to_dia(rows, cols, vals, shape, dtype=torch.float64,
                                device="cpu"))


def _systems(kind):
    """A JAX and a port operator on the same matrix, three right-hand
    sides and three starts.  ``spd``: 2D Poisson 20x20.  ``nonsym``: the
    same with a convection term.  ``indef``: a symmetric indefinite
    matrix with a well-separated spectrum (diagonal of alternating sign,
    magnitudes 1 to 3, weak tridiagonal coupling)."""
    if kind == "indef":
        size = 240
        i = np.arange(size)
        d = (1.0 + 2.0 * (i % 7) / 6.0) * np.where(i % 2, -1.0, 1.0)
        rows = np.concatenate([i, i[:-1], i[1:]])
        cols = np.concatenate([i, i[1:], i[:-1]])
        vals = np.concatenate([d, np.full(2 * (size - 1), 0.05)])
        shape = (size, size)
    else:
        rows, cols, vals, shape = jpoisson.poisson2d_coo(20, 20)
        vals = vals.copy()
        if kind == "nonsym":
            vals[cols == rows + 1] += 0.4
            vals[cols == rows - 1] -= 0.4
    jop, top = _dia_pair(rows, cols, vals, shape)
    size = shape[0]
    B = np.stack([np.asarray(jop.mv(jnp.ones(size))), _np(size, 1),
                  np.sin(np.arange(size))])
    return jop, top, B, 0.1 * _np((3, size), 2)


SOLVERS = [("cg", "spd"), ("minres", "spd"), ("minres", "indef"),
           ("bicgstab", "nonsym")]


class TestShortRecurrences:
    """``cg``, ``minres`` and ``bicgstab`` against JAX in f64: iteration
    counts equal per system, x to 1e-10, norms and flags alike; the batch
    against one JAX solve per column (what ``jax.vmap`` of the
    ``while_loop`` computes: a converged column stops changing)."""

    @pytest.mark.parametrize("name,kind", SOLVERS)
    @pytest.mark.parametrize("start", [False, True])
    @pytest.mark.parametrize("pc", [False, True])
    def test_single_and_batched_match_jax(self, name, kind, start, pc):
        jop, top, B, X0 = _systems(kind)
        dinv = 1.0 / np.abs(np.asarray(jop.to_dense()).diagonal())
        pj = (lambda v: jnp.asarray(dinv) * v) if pc else None
        pt = (lambda v: torch.from_numpy(dinv) * v) if pc else None
        kw = dict(rtol=1e-8, maxiter=2000)
        rj = [getattr(jkr, name)(jop.mv, jnp.asarray(B[i]),
                                 jnp.asarray(X0[i]) if start else None,
                                 precond=pj, **kw) for i in range(3)]
        rt = getattr(tkr, name)(top.mv, torch.from_numpy(B),
                                torch.from_numpy(X0) if start else None,
                                precond=pt, batched=True, **kw)
        assert rt.iters.tolist() == [int(r.iters) for r in rj]
        assert rt.converged.tolist() == [bool(r.converged) for r in rj]
        assert all(rt.converged.tolist())
        for i in range(3):
            _close(rt.x[i], rj[i].x, 1e-10)
            one = getattr(tkr, name)(top.mv, torch.from_numpy(B[i]),
                                     torch.from_numpy(X0[i]) if start
                                     else None, precond=pt, **kw)
            assert int(one.iters) == int(rj[i].iters)
            _close(one.x, rj[i].x, 1e-10)
            assert float(one.resnorm0) == pytest.approx(
                float(rj[i].resnorm0), rel=1e-12)
            assert float(rt.resnorm0[i]) == pytest.approx(
                float(rj[i].resnorm0), rel=1e-12)
        assert rt.syncs >= int(rt.iters.max()) // (2 if name == "bicgstab"
                                                   else 1)

    @pytest.mark.parametrize("name,kind", SOLVERS)
    def test_budget_atol_and_pinned_norm(self, name, kind):
        jop, top, B, _ = _systems(kind)
        b = B[1]
        for kw in (dict(rtol=1e-12, maxiter=7), dict(rtol=0.0, atol=1e-3),
                   dict(rtol=1e-6, rnorm0=50.0)):
            rj = getattr(jkr, name)(jop.mv, jnp.asarray(b), **kw)
            rt = getattr(tkr, name)(top.mv, torch.from_numpy(b), **kw)
            assert int(rt.iters) == int(rj.iters), kw
            assert bool(rt.converged) == bool(rj.converged), kw
            _close(rt.x, rj.x, 1e-10)
            _close(rt.resnorm0, rj.resnorm0, 1e-12)

    def test_minres_refuses_an_indefinite_preconditioner(self):
        jop, top, B, _ = _systems("spd")
        rj = jkr.minres(jop.mv, jnp.asarray(B[0]), precond=lambda v: -v)
        rt = tkr.minres(top.mv, torch.from_numpy(B[0]), precond=lambda v: -v)
        assert int(rt.iters) == int(rj.iters) == 0
        assert not bool(rt.converged) and not bool(rj.converged)

    def test_bicgstab_breakdown_is_not_convergence(self):
        # A = [[0, 1], [-1, 0]], b = e1: rhat . A p = 0 at the first step
        a = np.array([[0.0, 1.0], [-1.0, 0.0]])
        b = np.array([1.0, 0.0])
        rj = jkr.bicgstab(lambda v: jnp.asarray(a) @ v, jnp.asarray(b))
        rt = tkr.bicgstab(lambda v: torch.from_numpy(a) @ v,
                          torch.from_numpy(b))
        assert int(rt.iters) == int(rj.iters) == 2
        assert not bool(rt.converged) and not bool(rj.converged)
        _close(rt.x, rj.x, 1e-15)
