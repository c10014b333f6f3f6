"""Port parity for kernel M's two paths (``ops/coarse.py``,
``csrc/chebyshev_coarse.cuh``), on the CPU.

Kernel M's launcher puts a grid of at most 64 points with fewer than 32
a row (2D) or plane (3D) on its warp path, one warp a grid, each lane
owning 1 or 2 points; any other grid takes the block path.

The plain version, which the wrapper runs for CPU tensors, is held at the
warp path's shapes (the main path's 4^3 and 4x4, the strips' 2 x 4x8, a
grid at the second lane count's first point count, 3 x 11, and a 3D grid
of 60 points) and at the first grids past its limits (5 x 13, 2 x 32,
and the SM 3D strips' 4x8x8): to the port's ``chebyshev`` loop bit for
bit in f32, bf16 and f64; and at each single grid to the JAX package's
``chebyshev`` in f64 to 1e-12 relative to max|x| (the tolerance of
``test_torch_coarse.py``: JAX divides by theta where the port multiplies
by host-rounded scalars).  The CUDA kernel's two paths are held bit for bit against the
plain version and the loop on the card by ``python3 chip_smoke.py
coarse``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
    chebyshev as jcheb,
)
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

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
# (batch, grid): the warp path's grids (16, 32 and 64 points, 33 for the
# second lane count, 60 in 3D) and the first past its limits (65 points;
# a row of 32; 256, the SM 3D strips')
SHAPES = [((), (4, 4, 4)), ((), (4, 4)), ((2,), (4, 8)), ((), (3, 4, 5)),
          ((), (3, 11)), ((), (5, 13)), ((), (2, 32)), ((), (4, 8, 8))]


def _case(batch, dims, dtype, seed=0):
    diag, off = (6.0, -1.0) if len(dims) == 3 else (4.0, -1.0)
    lmin, lmax = tmg._dirichlet_bounds(dims, diag, off)
    b = np.random.default_rng(seed).standard_normal(batch + dims)
    return b, {"dims": dims, "diag": diag, "off": off,
               "coefs": chebyshev_coefficients(lmin, lmax, 40, dtype)}, \
        (lmin, lmax)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()]).numpy()


class TestWrapper:
    @pytest.mark.parametrize("dt", list(DTYPES))
    @pytest.mark.parametrize("batch,dims", SHAPES)
    def test_cpu_is_the_plain_version(self, batch, dims, dt):
        b, kw, _ = _case(batch, dims, DTYPES[dt])
        tb = torch.from_numpy(b).to(DTYPES[dt])
        x = coarse.chebyshev_coarse(tb, **kw)
        assert x.dtype == tb.dtype and x.shape == tb.shape
        np.testing.assert_array_equal(
            _bits(x), _bits(coarse.chebyshev_coarse_plain(tb, **kw)))


class TestPlain:
    @pytest.mark.parametrize("dt", list(DTYPES))
    @pytest.mark.parametrize("batch,dims", SHAPES)
    def test_against_the_loop(self, batch, dims, dt):
        b, kw, (lmin, lmax) = _case(batch, dims, DTYPES[dt])
        tb = torch.from_numpy(b).to(DTYPES[dt])
        x = coarse.chebyshev_coarse_plain(tb, **kw)
        A = tmg._make_op(dims, kw["diag"], kw["off"])
        loop = chebyshev(A.mv, tb, lmin=lmin, lmax=lmax, maxiter=40,
                         batched=bool(batch)).x
        np.testing.assert_array_equal(_bits(x), _bits(loop))

    @pytest.mark.parametrize("dims", [d for batch, d in SHAPES if not batch])
    def test_against_jax_f64(self, dims):
        b, kw, (lmin, lmax) = _case((), dims, torch.float64, seed=1)
        x = coarse.chebyshev_coarse_plain(torch.from_numpy(b), **kw).numpy()
        op = (jpoisson.poisson2d(*dims) if len(dims) == 2
              else jpoisson.poisson3d(*dims))
        xj = np.asarray(jcheb(op.mv, jnp.asarray(b.reshape(-1)), lmin=lmin,
                              lmax=lmax, maxiter=40).x).reshape(dims)
        np.testing.assert_allclose(x, xj, rtol=0,
                                   atol=1e-12 * np.abs(xj).max())
