"""Port parity for kernel M, the multigrid cycle's coarse Chebyshev solve
in one launch (``ops/coarse.py``), and its coefficient helper
(``solvers/chebyshev.chebyshev_coefficients``), on the CPU.

The plain version is held to the port's ``chebyshev`` loop bit for bit,
in f32, bf16 and f64, on every coarsest grid of the main path and an odd
one; to the JAX package's ``chebyshev`` in f64 to 1e-12 and in f32 to
1e-5, relative to max|x| (JAX computes the scalars on the device and
divides where the port multiplies by host-rounded scalars, so the two
round apart by an ulp a step, which 40 steps of a damped recurrence keep
small); bf16 is not held to JAX, which rounds at other places.  The
cycle with kernel M at its coarsest level gives the bits of the cycle
with the loop there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
    chebyshev as jcheb,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import coarse
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import multigrid as tmg
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    chebyshev,
    chebyshev_coefficients,
)

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

# (batch, grid): the coarsest grids of the 3D north-star, the 2D
# north-star, the SM 3D 64^3 strips and the 2D strips under pc='mg', and
# an odd grid that stops coarsening
SHAPES = [((), (4, 4, 4)), ((), (4, 4)), ((), (4, 8, 8)), ((2,), (4, 8)),
          ((), (4, 3, 5))]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}


def _stencil(dims):
    return (6.0, -1.0) if len(dims) == 3 else (4.0, -1.0)


def _case(batch, dims, dtype, seed=0, iters=40):
    diag, off = _stencil(dims)
    lmin, lmax = tmg._dirichlet_bounds(dims, diag, off)
    b = np.random.default_rng(seed).standard_normal(batch + dims)
    return b, diag, off, lmin, lmax, chebyshev_coefficients(
        lmin, lmax, iters, dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()]).numpy()


class TestPlainAgainstTheLoop:
    @pytest.mark.parametrize("dt", list(DTYPES))
    @pytest.mark.parametrize("batch,dims", SHAPES)
    def test_bit_for_bit(self, batch, dims, dt):
        dtype = DTYPES[dt]
        b, diag, off, lmin, lmax, coefs = _case(batch, dims, dtype)
        tb = torch.from_numpy(b).to(dtype)
        x = coarse.chebyshev_coarse_plain(tb, dims=dims, diag=diag, off=off,
                                          coefs=coefs)
        A = tmg._make_op(dims, diag, off)
        loop = chebyshev(A.mv, tb, lmin=lmin, lmax=lmax, maxiter=40,
                         batched=bool(batch)).x
        assert x.dtype == dtype and x.shape == tb.shape
        np.testing.assert_array_equal(_bits(x), _bits(loop))
        # the wrapper takes its plain version on the CPU
        xw = coarse.chebyshev_coarse(tb, dims=dims, diag=diag, off=off,
                                     coefs=coefs)
        np.testing.assert_array_equal(_bits(xw), _bits(loop))


class TestCoefficients:
    @pytest.mark.parametrize("dt", list(DTYPES))
    @pytest.mark.parametrize("bounds", [(0.35, 11.65), (0.02, 7.98),
                                        (1.0, 2.0)])
    def test_helper_is_the_rnd_chain(self, bounds, dt):
        """The chain ``chebyshev`` computed inline before the helper."""
        dtype = DTYPES[dt]
        lmin, lmax = bounds

        def rnd(v):
            return torch.tensor(v, dtype=dtype).item()

        theta = rnd((lmax + lmin) / 2.0)
        delta = rnd((lmax - lmin) / 2.0)
        sigma1 = rnd(theta / delta)
        rho = rnd(1.0 / sigma1)
        steps = []
        for _ in range(25):
            rho_new = rnd(1.0 / rnd(rnd(2.0 * sigma1) - rho))
            steps.append((rnd(rho_new * rho), rnd(rnd(2.0 * rho_new) / delta)))
            rho = rho_new
        assert chebyshev_coefficients(lmin, lmax, 25, dtype) == (
            theta, tuple(steps))
        # every scalar is exact in the dtype
        theta_h, steps_h = chebyshev_coefficients(lmin, lmax, 25, dtype)
        for v in (theta_h,) + sum(steps_h, ()):
            assert rnd(v) == v


def _jax_chebyshev(batch, dims, b, lmin, lmax, dtype):
    op = (jpoisson.poisson3d if len(dims) == 3 else jpoisson.poisson2d)(*dims)

    def one(bg):
        return jcheb(op.mv, bg.reshape(-1), lmin=lmin, lmax=lmax,
                     maxiter=40).x.reshape(dims)

    jb = jnp.asarray(b, dtype)
    return np.asarray(jax.vmap(one)(jb) if batch else one(jb))


class TestPlainAgainstJax:
    @pytest.mark.parametrize("dt,tol", [("f64", 1e-12), ("f32", 1e-5)])
    @pytest.mark.parametrize("batch,dims", SHAPES)
    def test_agrees(self, batch, dims, dt, tol):
        b, diag, off, lmin, lmax, coefs = _case(batch, dims, DTYPES[dt],
                                                seed=1)
        x = coarse.chebyshev_coarse_plain(
            torch.from_numpy(b).to(DTYPES[dt]), dims=dims, diag=diag,
            off=off, coefs=coefs).numpy()
        xj = _jax_chebyshev(batch, dims, b, lmin, lmax,
                            jnp.float64 if dt == "f64" else jnp.float32)
        scale = np.abs(xj).max()
        np.testing.assert_allclose(x, xj, rtol=0, atol=tol * scale)


class TestCycle:
    @pytest.mark.parametrize("dims,cycle,dt", [
        ((16, 16, 16), "w", "f32"), ((16, 16, 16), "v", "f64"),
        ((32, 32, 32), "w", "bf16"), ((64, 64), "w", "f32"),
        ((32, 32), "v", "f64"), ((20, 12, 12), "w", "f32")])
    def test_kernel_m_route_keeps_the_bits(self, dims, cycle, dt,
                                           monkeypatch):
        """``vcycle`` with kernel M at the coarsest level against the same
        cycle with the Chebyshev loop there (every grid refused)."""
        top = (tpoisson.poisson3d if len(dims) == 3 else tpoisson.poisson2d)(
            *dims)
        levels = tmg.plan(top, cycle=cycle)
        assert coarse.fits(levels.dims[-1], levels.coarse_iters)
        r = torch.from_numpy(np.random.default_rng(2).standard_normal(dims)
                             ).to(DTYPES[dt])
        z = tmg.vcycle(levels, r)
        monkeypatch.setattr(coarse, "fits", lambda dims, steps: False)
        z_loop = tmg.vcycle(levels, r)
        np.testing.assert_array_equal(_bits(z), _bits(z_loop))

    def test_stack_of_strips(self, monkeypatch):
        """The 2D cycle on a stack of grids, as inner ``pc='mg'`` runs it."""
        levels = tmg.plan(tpoisson.poisson2d(16, 32))
        assert levels.dims[-1] == (4, 8)
        r = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (2, 16, 32))).to(torch.float32)
        z = tmg.vcycle(levels, r)
        monkeypatch.setattr(coarse, "fits", lambda dims, steps: False)
        np.testing.assert_array_equal(_bits(z), _bits(tmg.vcycle(levels, r)))


class TestWrapper:
    def test_fits(self):
        assert coarse.fits((4, 4, 4), 40) and coarse.fits((64, 64), 40)
        assert coarse.fits((16, 16, 16), coarse.MAX_STEPS)
        assert not coarse.fits((17, 16, 16), 40)
        assert not coarse.fits((4, 4, 4), coarse.MAX_STEPS + 1)
        assert not coarse.fits((4,), 40)

    def test_rejects(self):
        coefs = chebyshev_coefficients(1.0, 2.0, 3, torch.float32)
        with pytest.raises(ValueError, match="stack of them"):
            coarse.chebyshev_coarse(torch.zeros(4, 5), dims=(4, 4), diag=4.0,
                                    off=-1.0, coefs=coefs)
        with pytest.raises(ValueError, match="not a grid"):   # one 3D grid
            coarse.chebyshev_coarse(torch.zeros(2, 4, 4, 4), dims=(4, 4, 4),
                                    diag=6.0, off=-1.0, coefs=coefs)
        with pytest.raises(ValueError, match="2D or 3D"):
            coarse.chebyshev_coarse(torch.zeros(4), dims=(4,), diag=2.0,
                                    off=-1.0, coefs=coefs)
        with pytest.raises(ValueError, match="takes"):
            coarse.chebyshev_coarse(torch.zeros(4, 4, dtype=torch.float16),
                                    dims=(4, 4), diag=4.0, off=-1.0,
                                    coefs=coefs)

    def test_launch_coefficients(self):
        """The launch's coefficients: 1/theta as CUDA's ``r / theta``
        takes it (in f32 for f32 and bf16, in f64 for f64), then the
        steps' pairs."""
        for dtype in DTYPES.values():
            theta, steps = coefs = chebyshev_coefficients(0.35, 11.65, 3,
                                                          dtype)
            arr = list(coarse._coef_array(coefs, dtype))
            inv = (1.0 / theta if dtype == torch.float64 else
                   float(np.float32(1.0) / np.float32(theta)))
            assert arr == [inv] + [c for pair in steps for c in pair]
