"""Port parity for the fused stencil kernels of PCG and of the residual
norm: ``stencil3d_axpy_mv_dot`` (``ops/stencil3d.py``),
``stencil3d_mv_norm``, ``stencil2d_mv_norm`` and ``residual_norm_sq``
(``ops/fused.py``), ``Stencil3D.axpy_mv_dot`` and ``cg``'s
``matvec_axpy_dot`` hook.

The kernels' plain PyTorch versions, which the wrappers run for CPU
tensors, are held against the JAX package's Pallas kernels in interpret
mode at the shapes ``tests/test_pallas.py`` uses (16^3 with ``tile_m=4``,
32^2 with ``tile_m=8``), on the same inputs made with numpy from a seed.
The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.

Tolerances: f32 rtol 1e-6 with an absolute floor of 1e-6 * max|ref| (the
taps are summed in another order and a value can cancel to near zero);
bf16 2 bf16 ulps plus the same floor; dots and norms rtol 1e-5 (sums in
another order).  The 2D apply agrees with the Pallas kernel in every
bit, as the JAX package asserts of its own two forms.  In f64 ``cg``
with the hook and ``cg`` with the axpy and ``mv_dot`` take the same
iterations to the same iterate (1e-12), and as many as the JAX ``cg``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.ops import fused_pallas as fp
from medane_tchakorom_ufc_thesis_repository_tpu.ops import stencil_pallas as sp
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov as jkr
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import multigrid as jmg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    DIA,
    Stencil2D,
    Stencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import (
    poisson2d_dia,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build, fused
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov as tkr
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid as tmg

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture()
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(t, j, tol):
    got = t.to(torch.float64).numpy()
    ref = np.asarray(j, np.float64)
    assert got.shape == ref.shape
    floor = 1e-6 * np.abs(ref).max()
    if tol == "f32":
        bound = 1e-6 * np.abs(ref) + floor
    elif tol == "bf16":
        ulp = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 8)
        bound = 2 * np.where(ref == 0, 0.0, ulp) + floor
    else:  # dot
        bound = 1e-5 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= bound), np.max(np.abs(got - ref) - bound)


@pytest.mark.usefixtures("_interpret")
class TestPlainVersusPallas:
    @pytest.mark.parametrize("beta", [0.37, 0.0, -1.25])
    @pytest.mark.parametrize("d,shape", [("f32", (16, 16, 16)),
                                         ("f32", (16, 16, 32)),
                                         ("bf16", (16, 16, 16))])
    def test_axpy_mv_dot(self, d, shape, beta):
        z, p = _np(shape, 9), _np(shape, 10)
        pj, aj, dj = sp.stencil3d_axpy_mv_dot_pallas(
            jnp.asarray(z).astype(JDT[d]), jnp.asarray(p).astype(JDT[d]),
            jnp.float32(beta), nx=shape[0], ny=shape[1], nz=shape[2],
            tile_m=4)
        pt, at, dt_ = k.stencil3d_axpy_mv_dot_plain(
            torch.from_numpy(z).to(TDT[d]), torch.from_numpy(p).to(TDT[d]),
            beta, diag=6.0, off=-1.0)
        assert pt.dtype == at.dtype == TDT[d]
        assert dt_.dtype == torch.float32 and dt_.dim() == 0
        _assert_close(pt, pj, d)
        _assert_close(at, aj, d)
        _assert_close(dt_, dj, "dot")

    def test_mv_norm_3d(self):
        nx = ny = nz = 16
        x, b = _np(nx * ny * nz, 1), _np(nx * ny * nz, 2)
        yj, sj = fp.stencil3d_mv_norm_pallas(
            jnp.asarray(x), jnp.asarray(b), nx=nx, ny=ny, nz=nz, tile_m=4)
        yt, st = fused.stencil3d_mv_norm_plain(
            torch.from_numpy(x), torch.from_numpy(b), nx=nx, ny=ny, nz=nz)
        assert tuple(yt.shape) == (nx * ny * nz,) and st.dim() == 0
        _assert_close(yt, yj, "f32")
        _assert_close(st, sj, "dot")

    def test_mv_norm_2d(self):
        m = n = 32
        x, b = _np(m * n, 1), _np(m * n, 2)
        yj, sj = fp.stencil2d_mv_norm_pallas(
            jnp.asarray(x), jnp.asarray(b), m=m, n=n, tile_m=8)
        yt, st = fused.stencil2d_mv_norm_plain(
            torch.from_numpy(x), torch.from_numpy(b), m=m, n=n)
        assert tuple(yt.shape) == (m * n,) and st.dim() == 0
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        _assert_close(st, sj, "dot")

    @pytest.mark.parametrize("dims", [(32, 32), (16, 16, 16)])
    def test_residual_norm_sq_routes(self, dims, monkeypatch):
        """``residual_norm_sq`` on a stencil gives what the JAX one gives
        with its Pallas route on."""
        monkeypatch.setenv("MEDANE_TPU_PALLAS", "1")
        jop = jops.Stencil2D(*dims) if len(dims) == 2 else jops.Stencil3D(*dims)
        top = Stencil2D(*dims) if len(dims) == 2 else Stencil3D(*dims)
        size = int(np.prod(dims))
        x, b = _np(size, 3), _np(size, 4)
        yj, sj = fp.residual_norm_sq(jop, jnp.asarray(x), jnp.asarray(b))
        yt, st = fused.residual_norm_sq(top, torch.from_numpy(x),
                                        torch.from_numpy(b))
        _assert_close(yt, yj, "f32")
        _assert_close(st, sj, "dot")


class TestWrappers:
    def test_y_is_the_operators_mv(self):
        """K and L return the bits of ``Stencil3D.mv`` / ``Stencil2D.mv``
        (on the CPU both are the plain apply), in f32 and f64."""
        for dtype in (torch.float32, torch.float64):
            x = torch.from_numpy(_np(6 * 5 * 7, 5)).to(dtype)
            b = torch.from_numpy(_np(6 * 5 * 7, 6)).to(dtype)
            y, s = fused.stencil3d_mv_norm(x, b, nx=6, ny=5, nz=7)
            assert torch.equal(y, Stencil3D(6, 5, 7).mv(x)) and s.dtype == dtype
            torch.testing.assert_close(s, torch.sum((b - y) ** 2))
            y, s = fused.stencil2d_mv_norm(x, b, m=14, n=15)
            assert torch.equal(y, Stencil2D(14, 15).mv(x)) and s.dtype == dtype
            torch.testing.assert_close(s, torch.sum((b - y) ** 2))

    def test_residual_norm_sq_other_operator(self):
        """Any other operator takes the two-pass form."""
        op = poisson2d_dia(6, 7, dtype=torch.float64, device="cpu")
        assert isinstance(op, DIA)
        x = torch.from_numpy(_np(42, 7)).double()
        b = torch.from_numpy(_np(42, 8)).double()
        y, s = fused.residual_norm_sq(op, x, b)
        assert torch.equal(y, op.mv(x))
        torch.testing.assert_close(s, torch.sum((b - y) ** 2))
        y2, s2 = fused.residual_norm_sq(Stencil2D(6, 7), x, b)
        torch.testing.assert_close(y2, y)
        torch.testing.assert_close(s2, s)

    def test_cpu_takes_plain_and_counts_nothing(self):
        build.reset_launch_counts()
        z = torch.from_numpy(_np((4, 4, 6), 13))
        p = torch.from_numpy(_np((4, 4, 6), 14))
        out = k.stencil3d_axpy_mv_dot(z, p, torch.tensor(0.5), diag=6.0,
                                      off=-1.0)
        ref = k.stencil3d_axpy_mv_dot_plain(z, p, 0.5, diag=6.0, off=-1.0)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        fused.stencil3d_mv_norm(z.reshape(-1), p.reshape(-1), nx=4, ny=4, nz=6)
        fused.stencil2d_mv_norm(z.reshape(-1), p.reshape(-1), m=8, n=12)
        assert build.launch_counts() == {}

    def test_axpy_is_the_two_plain_passes(self):
        """``p'`` has the bits of ``z + beta * p`` and the triple is what
        the axpy followed by ``mv_dot`` gives, so that ``cg`` takes the
        same path with and without the hook."""
        z = torch.from_numpy(_np((6, 5, 7), 15))
        p = torch.from_numpy(_np((6, 5, 7), 16))
        beta = torch.tensor(-0.3)
        pn, ap, d = k.stencil3d_axpy_mv_dot(z, p, beta, diag=6.0, off=-1.0)
        ref = z + beta * p
        y, dd = k.stencil3d_apply(ref, kind="mv_dot", diag=6.0, off=-1.0)
        assert torch.equal(pn, ref) and torch.equal(ap, y) and torch.equal(d, dd)

    @pytest.mark.parametrize("case", [
        "j_shape", "j_dtype", "j_beta_shape", "j_int", "k_grid_shaped",
        "k_size", "k_bf16", "k_dtype_mismatch", "l_noncontiguous", "l_size"])
    def test_rejects(self, case):
        z = torch.zeros(4, 4, 6)
        v = torch.zeros(96)
        calls = {
            "j_shape": lambda: k.stencil3d_axpy_mv_dot(
                z, torch.zeros(4, 4, 4), 0.1, diag=6.0, off=-1.0),
            "j_dtype": lambda: k.stencil3d_axpy_mv_dot(
                z, z.double(), 0.1, diag=6.0, off=-1.0),
            "j_beta_shape": lambda: k.stencil3d_axpy_mv_dot(
                z, z, torch.zeros(2), diag=6.0, off=-1.0),
            "j_int": lambda: k.stencil3d_axpy_mv_dot(
                z.int(), z.int(), 1, diag=6.0, off=-1.0),
            "k_grid_shaped": lambda: fused.stencil3d_mv_norm(
                z, z, nx=4, ny=4, nz=6),
            "k_size": lambda: fused.stencil3d_mv_norm(v, v, nx=4, ny=4, nz=4),
            "k_bf16": lambda: fused.stencil3d_mv_norm(
                v.bfloat16(), v.bfloat16(), nx=4, ny=4, nz=6),
            "k_dtype_mismatch": lambda: fused.stencil3d_mv_norm(
                v, v.double(), nx=4, ny=4, nz=6),
            "l_noncontiguous": lambda: fused.stencil2d_mv_norm(
                torch.zeros(96, 2)[:, 0], v, m=8, n=12),
            "l_size": lambda: fused.stencil2d_mv_norm(v, v, m=8, n=8),
        }
        with pytest.raises(ValueError):
            calls[case]()


class TestOperatorAndHook:
    SHAPE = (8, 8, 8)

    @pytest.mark.parametrize("flat", [False, True])
    def test_axpy_mv_dot_method(self, flat):
        """``Stencil3D.axpy_mv_dot`` against the JAX method in f64."""
        rng = np.random.default_rng(17)
        z, p = rng.standard_normal(self.SHAPE), rng.standard_normal(self.SHAPE)
        if flat:
            z, p = z.reshape(-1), p.reshape(-1)
        pj, aj, dj = jops.Stencil3D(*self.SHAPE).axpy_mv_dot(
            jnp.asarray(z), jnp.asarray(p), 0.37)
        pt, at, dt_ = Stencil3D(*self.SHAPE).axpy_mv_dot(
            torch.from_numpy(z), torch.from_numpy(p),
            torch.tensor(0.37, dtype=torch.float64))
        assert tuple(pt.shape) == z.shape and pt.dtype == torch.float64
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(float(dt_), float(dj), rtol=1e-5)

    @pytest.mark.parametrize("precond", [False, True])
    def test_cg_hook_counts_and_iterates(self, precond):
        """f64 ``cg``: with the hook, with the axpy and ``mv_dot``, and
        the JAX ``cg`` with its hook: equal iteration counts; the port's
        two iterates agree to 1e-12, and with JAX's to 1e-6, because the
        fused dots are f32 sums in both packages, taken in another order
        (rtol 1e-6 keeps the solve above that noise)."""
        n = 16
        jop, top = jops.Stencil3D(n, n, n), Stencil3D(n, n, n)
        b = np.asarray(jop.mv(jnp.ones((n, n, n))))
        kwj, kwt = {}, {}
        if precond:
            kwj["precond_dot"] = jmg.mg_preconditioner(jop, return_rdot=True)
            kwt["precond_dot"] = tmg.mg_preconditioner(top, return_rdot=True)
        rj = jkr.cg(jop.mv, jnp.asarray(b), rtol=1e-6, maxiter=200,
                    matvec_dot=jop.mv_dot, matvec_axpy_dot=jop.axpy_mv_dot,
                    **kwj)
        bt = torch.from_numpy(b)
        hook = tkr.cg(top.mv, bt, rtol=1e-6, maxiter=200,
                      matvec_dot=top.mv_dot,
                      matvec_axpy_dot=top.axpy_mv_dot, **kwt)
        plain = tkr.cg(top.mv, bt, rtol=1e-6, maxiter=200,
                       matvec_dot=top.mv_dot, **kwt)
        assert hook.iters == plain.iters == int(rj.iters)
        assert bool(hook.converged) and hook.syncs == plain.syncs
        scale = np.abs(np.asarray(rj.x)).max()
        assert (hook.x - plain.x).abs().max() <= 1e-12 * scale
        assert np.abs(hook.x.numpy() - np.asarray(rj.x)).max() <= 1e-6 * scale

    def test_cg_hook_takes_precedence_and_beta_is_a_tensor(self):
        """The hook replaces ``matvec_dot`` for the direction matvec and
        is handed ``beta`` as a 0-d tensor (no host read)."""
        top = Stencil3D(4, 4, 4)
        b = torch.from_numpy(_np((4, 4, 4), 18)).double()
        seen = []

        def amvd(z, p, beta):
            seen.append(beta)
            return top.axpy_mv_dot(z, p, beta)

        def never(p):
            raise AssertionError("matvec_dot was called for the direction")

        res = tkr.cg(top.mv, b, rtol=1e-8, maxiter=50, matvec_dot=never,
                     matvec_axpy_dot=amvd)
        assert bool(res.converged) and len(seen) == res.iters
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in seen)
        assert float(seen[0]) == 0.0

    def test_cg_hook_refuses_a_batch(self):
        top = Stencil3D(4, 4, 4)
        with pytest.raises(ValueError, match="one system"):
            tkr.cg(top.mv, torch.zeros(2, 64), batched=True,
                   matvec_axpy_dot=top.axpy_mv_dot)
