"""Port parity for kernel E's row-tile walk (``ops/stencil2d.py``,
``csrc/stencil2d.cu``) at the walk's edges, on the CPU.

A block of the walk owns up to 32 16-byte vectors of a row (128 f32
values, 256 bf16, 64 f64) and walks a slab of up to 128 rows (64 among
them); a row whose length is not a multiple of the vector takes the scalar
path.  The edge shapes: one row (n of 130 on the scalar path, 128 and 256
on the 16-byte path), a slab of 64 rows and one row either side of it, 37
rows; n of 1, 3, 4 and 5 (an f32 vector and one value either side), 129
and 130 (a tile of 128 f32 values and one or two past it); a batch of 3,
whose grids stay apart (the batch index is a hard boundary).  At each,
the plain version, which the wrapper runs for CPU tensors, is held
against the JAX package's Pallas kernels in interpret mode (as
``tests/test_pallas.py`` runs them) on the same inputs made with numpy
from a seed:
``stencil2d_spmm_pallas`` on the batch as a basis panel, in f32, bf16
and f64, and ``stencil2d_mv_pallas`` on a single grid whose rows divide
into its 8-row tiles, in f32 and f64.

Tolerances: f32 rtol 1e-6 with an absolute floor of 1e-6 * max|ref|, f64
the same at 1e-12 (``test_torch_stencil2d.py``'s: the Pallas kernels may
contract another multiply-add, and an apply can cancel to near zero).
bf16: the Pallas kernel rounds each of its six operations to bf16 where
the plain version computes in f32 and rounds once, so the two differ by a
few bf16 ulps of the terms: |y - yj| <= 2^-5 (|diag c| + |off| (|up| +
|down| + |left| + |right|)).

The kernel's launcher chooses the tile and the slab from the shape and
dtype; the CUDA kernel is held bit for bit against the plain version on
the card by ``python3 chip_smoke.py kernels2d``.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.ops import fused_pallas as fp
from medane_tchakorom_ufc_thesis_repository_tpu.ops import stencil_pallas as sp
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as k

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

DIAG, OFF = 4.0, -1.0
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f64": (torch.float64, jnp.float64)}
# (batch, m, n): every edge above; the single grid of 64 rows also goes
# through stencil2d_mv_pallas
SHAPES = [(1, 1, 1), (3, 1, 130), (3, 1, 128), (2, 1, 256), (3, 63, 3),
          (3, 65, 4), (3, 37, 5), (1, 64, 129)]


@pytest.fixture()
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(shape, dt):
    """The same values for both packages, made with numpy from a seed and
    rounded to the dtype."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape)
    if dt == "bf16":
        return x.astype(ml_dtypes.bfloat16)
    return x.astype(np.float32 if dt == "f32" else np.float64)


def _assert_agrees(yt, yj, x, dt):
    got = yt.to(torch.float64).numpy()
    ref = np.asarray(yj).astype(np.float64)
    assert got.shape == ref.shape
    if dt == "bf16":
        a = np.pad(np.abs(x.astype(np.float64)), ((0, 0), (1, 1), (1, 1)))
        taps = (a[:, :-2, 1:-1] + a[:, 2:, 1:-1] + a[:, 1:-1, :-2]
                + a[:, 1:-1, 2:])
        bound = 2.0 ** -5 * (abs(DIAG) * a[:, 1:-1, 1:-1] + abs(OFF) * taps)
    else:
        rtol = 1e-6 if dt == "f32" else 1e-12
        bound = rtol * np.abs(ref) + rtol * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound), np.max(np.abs(got - ref) - bound)


@pytest.mark.usefixtures("_interpret")
class TestPlainAgainstPallas:
    @pytest.mark.parametrize("dt", list(DTYPES))
    @pytest.mark.parametrize("shape", SHAPES)
    def test_edges(self, shape, dt):
        tdt, jdt = DTYPES[dt]
        batch, m, n = shape
        x = _inputs(shape, dt)
        xt = torch.from_numpy(x.astype(np.float64)).to(tdt)
        yt = k.stencil2d_apply_plain(xt, diag=DIAG, off=OFF)
        assert yt.dtype == tdt and tuple(yt.shape) == shape
        # the wrapper takes its plain version on the CPU
        torch.testing.assert_close(k.stencil2d_apply(xt, diag=DIAG, off=OFF),
                                   yt, rtol=0, atol=0)
        yj = fp.stencil2d_spmm_pallas(jnp.asarray(x.reshape(batch, m * n), jdt),
                                      m=m, n=n, diag=DIAG, off=OFF)
        _assert_agrees(yt, np.asarray(yj).reshape(shape), x, dt)
        if batch == 1 and m % 8 == 0 and dt != "bf16":
            yj = sp.stencil2d_mv_pallas(jnp.asarray(x[0], jdt), m=m, n=n,
                                        diag=DIAG, off=OFF)
            _assert_agrees(yt, np.asarray(yj)[None], x, dt)
