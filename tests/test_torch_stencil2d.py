"""Port parity for the 2D 5-point stencil (kernel E, ``ops/stencil2d.py``)
and the stacked strip operators built on it (``models/blockops.py``).

The kernel's plain PyTorch version, which the wrapper runs for CPU
tensors, is held against the JAX package's Pallas kernels in interpret
mode (as ``tests/test_pallas.py`` runs them): ``stencil2d_mv_pallas`` for
one grid and ``stencil2d_spmm_pallas`` for a basis panel, on the same f32
inputs made with numpy from a seed.  The operators are held against the
JAX ``Stencil2D`` and ``StackedStencil2D``/``StackedStencil3D`` in f64.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.

Tolerances: f32 rtol 1e-6 with an absolute floor of 1e-6 * max|ref| (PR
1's: the Pallas kernels pair the taps in another order, and an apply can
cancel to near zero); f64 rtol 1e-12 with the same floor at 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.ops import fused_pallas as fp
from medane_tchakorom_ufc_thesis_repository_tpu.ops import stencil_pallas as sp
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
    poisson_strip_eig_bounds_2d as jbounds2d,
    poisson_strip_eig_bounds_3d as jbounds3d,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops as tbo
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil2d as k
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import chebyshev as tcheb

DIAG, OFF = 4.0, -1.0


@pytest.fixture()
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _assert_close(t, ref, rtol):
    got = t.to(torch.float64).numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    bound = rtol * np.abs(ref) + rtol * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound), np.max(np.abs(got - ref) - bound)


@pytest.mark.usefixtures("_interpret")
class TestPlainVersusPallas:
    def test_mv(self):
        m, n = 64, 128
        x = _np((m, n), 1)
        yj = sp.stencil2d_mv_pallas(jnp.asarray(x), m=m, n=n, tile_m=16)
        yt = k.stencil2d_apply_plain(torch.from_numpy(x)[None], diag=DIAG,
                                     off=OFF)
        assert yt.dtype == torch.float32 and tuple(yt.shape) == (1, m, n)
        _assert_close(yt[0], yj, 1e-6)

    @pytest.mark.parametrize("s", [1, 4])
    def test_spmm_panel(self, s):
        m, n = 32, 64
        S = _np((s, m * n), 2)
        Rj = fp.stencil2d_spmm_pallas(jnp.asarray(S), m=m, n=n, tile_m=8)
        Rt = k.stencil2d_apply_plain(torch.from_numpy(S).reshape(s, m, n),
                                     diag=DIAG, off=OFF)
        _assert_close(Rt.reshape(s, m * n), Rj, 1e-6)

    def test_batch_is_a_hard_boundary(self):
        """Each grid of a batch is bounded by zeros: the apply on a batch
        is the apply on each grid alone."""
        x = torch.from_numpy(_np((3, 37, 130), 3))
        y = k.stencil2d_apply_plain(x, diag=DIAG, off=OFF)
        for b in range(3):
            one = k.stencil2d_apply_plain(x[b:b + 1].contiguous(), diag=DIAG,
                                          off=OFF)
            torch.testing.assert_close(y[b:b + 1], one, rtol=0, atol=0)
        # and each grid is the dense operator's product
        dense = tpoisson.poisson2d_dense_np(37, 130)
        np.testing.assert_allclose(
            y[1].double().numpy().reshape(-1),
            dense @ x[1].double().numpy().reshape(-1), rtol=1e-5, atol=1e-5)


class TestOperatorF64:
    """``Stencil2D`` and the 2D generators against the JAX package."""

    @pytest.mark.parametrize("flat", [False, True])
    @pytest.mark.parametrize("shape", [(6, 9), (1, 5), (8, 1)])
    def test_mv(self, shape, flat):
        m, n = shape
        x = _np(shape, 4, np.float64)
        if flat:
            x = x.reshape(-1)
        yj = jops.Stencil2D(m, n).mv(jnp.asarray(x))
        yt = tpoisson.poisson2d(m, n).mv(torch.from_numpy(x))
        assert tuple(yt.shape) == x.shape and yt.dtype == torch.float64
        _assert_close(yt, yj, 1e-12)

    def test_generators_and_metadata(self):
        m, n = 5, 7
        jop, top = jpoisson.poisson2d(m, n), tpoisson.poisson2d(m, n)
        assert top.shape == jop.shape and top.nnz == jop.nnz
        for a, b in zip(tpoisson.poisson2d_coo(m, n), jpoisson.poisson2d_coo(m, n)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        dense = tpoisson.poisson2d_dense_np(m, n)
        np.testing.assert_array_equal(dense, jpoisson.poisson2d_dense_np(m, n))
        np.testing.assert_array_equal(top.to_dense(torch.float64, "cpu").numpy(),
                                      dense)
        bt = tpoisson.rhs_for_exact_ones(top, torch.float64, "cpu")
        np.testing.assert_array_equal(bt.numpy(),
                                      np.asarray(jpoisson.rhs_for_exact_ones(jop)))
        # the operator is the dense matrix
        x = _np(m * n, 5, np.float64)
        np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(),
                                   dense @ x, rtol=1e-12, atol=1e-12)

    def test_strip_eig_bounds(self):
        assert tcheb.poisson_strip_eig_bounds_2d(16, 32) == \
            jbounds2d(16, 32)
        assert tcheb.poisson_strip_eig_bounds_3d(4, 8, 8) == \
            jbounds3d(4, 8, 8)
        # the 2D bounds enclose the dense strip operator's spectrum
        ev = np.linalg.eigvalsh(tpoisson.poisson2d_dense_np(6, 5))
        lo, hi = tcheb.poisson_strip_eig_bounds_2d(6, 5)
        np.testing.assert_allclose([ev.min(), ev.max()], [lo, hi], rtol=1e-12)


STACKS = [
    ("2d", lambda: (jbo.block_poisson2d(12, 10, 3), tbo.block_poisson2d(12, 10, 3))),
    ("2d_rows1", lambda: (jbo.block_poisson2d(4, 6, 4), tbo.block_poisson2d(4, 6, 4))),
    ("3d", lambda: (jbo.block_poisson3d(8, 6, 5), tbo.block_poisson3d(8, 6, 5))),
]


class TestStackedF64:
    """The stacked strip operators against JAX's, on a stack and on a
    basis panel ``(s, nb, bs)`` (JAX: ``vmap`` over the panel)."""

    # the applies also take a basis panel; the coupling takes one stack
    @pytest.mark.parametrize("method,panel", [
        ("diag_mv", False), ("diag_mv", True), ("full_mv", False),
        ("full_mv", True), ("coupling_mv", False)])
    @pytest.mark.parametrize("case", [c for c, _ in STACKS])
    def test_methods(self, case, method, panel):
        jop, top = dict(STACKS)[case]()
        shape = ((3,) if panel else ()) + (top.nblocks, top.block_size)
        x = _np(shape, 6, np.float64)
        fj = getattr(jop, method)
        yj = (np.stack([np.asarray(fj(jnp.asarray(c))) for c in x]) if panel
              else np.asarray(fj(jnp.asarray(x))))
        yt = getattr(top, method)(torch.from_numpy(x))
        assert tuple(yt.shape) == shape and yt.dtype == torch.float64
        _assert_close(yt, yj, 1e-12)

    @pytest.mark.parametrize("case", [c for c, _ in STACKS])
    def test_halos_metadata_and_hooks(self, case):
        jop, top = dict(STACKS)[case]()
        assert (top.nblocks, top.block_size, top.rows, top.shape, top.nnz) == \
            (jop.nblocks, jop.block_size, jop.rows, jop.shape, jop.nnz)
        assert top.diag_eig_bounds() == jop.diag_eig_bounds()
        x = _np((top.nblocks, top.block_size), 7, np.float64)
        for a, b in zip(top.halos(torch.from_numpy(x)), jop.halos(jnp.asarray(x))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            top.single_diag_vector(None, 5).numpy(),
            np.asarray(jop.single_diag_vector(None, 5)))
        # one block's A_ii alone
        xb = torch.from_numpy(x[1:2])
        np.testing.assert_allclose(
            top.single_diag_mv(None, xb)[0].numpy(),
            np.asarray(jop.single_diag_mv(None, jnp.asarray(x[1]))),
            rtol=1e-12, atol=1e-12)
        assert convert.from_jax_operator(jop) == top

    def test_full_mv_is_the_dense_operator_and_rhs(self):
        jop, top = jbo.block_poisson2d(8, 6, 2), tbo.block_poisson2d(8, 6, 2)
        dense = tpoisson.poisson2d_dense_np(8, 6)
        np.testing.assert_array_equal(dense, np.asarray(jop.to_dense()))
        x = _np(48, 8, np.float64)
        np.testing.assert_allclose(
            top.full_mv(torch.from_numpy(x).reshape(2, 24)).reshape(-1).numpy(),
            dense @ x, rtol=1e-12, atol=1e-12)
        bt = tbo.rhs_ones(top, torch.float64, "cpu")
        np.testing.assert_array_equal(
            bt.numpy(), np.asarray(jbo.rhs_ones(jop, jnp.float64)))

    def test_final_residual_norm(self):
        jop, top = jbo.block_poisson2d(8, 6, 2), tbo.block_poisson2d(8, 6, 2)
        xs = _np((2, 48), 9, np.float64)
        bs = _np((2, 24), 10, np.float64)
        np.testing.assert_allclose(
            float(tbo.final_residual_norm(top, torch.from_numpy(xs),
                                          torch.from_numpy(bs))),
            float(jbo.final_residual_norm(jop, xs, bs)), rtol=1e-12)

    def test_strips_are_cut_and_full_mv_is_not(self):
        """``diag_mv`` bounds each strip by zeros; ``full_mv`` sees the
        neighbour strip: the two differ by exactly the coupling."""
        top = tbo.block_poisson2d(16, 8, 2)
        x = torch.from_numpy(_np((2, 64), 11, np.float64))
        torch.testing.assert_close(top.full_mv(x) - top.diag_mv(x),
                                   top.coupling_mv(x), rtol=0, atol=1e-12)


class TestWrapper:
    def test_cpu_takes_plain_and_counts_nothing(self):
        build.reset_launch_counts()
        x = torch.from_numpy(_np((2, 5, 7), 12))
        torch.testing.assert_close(
            k.stencil2d_apply(x, diag=DIAG, off=OFF, panel=True),
            k.stencil2d_apply_plain(x, diag=DIAG, off=OFF), rtol=0, atol=0)
        tbo.block_poisson2d(10, 7, 2).full_mv(x.reshape(2, 35).double())
        assert build.launch_counts() == {}

    @pytest.mark.parametrize("case", ["meta_device", "two_dims", "empty",
                                      "noncontiguous", "bf16", "int"])
    def test_rejects(self, case):
        x = torch.zeros(2, 4, 6)
        bad = {
            "meta_device": torch.zeros(2, 4, 6, device="meta"),
            "two_dims": torch.zeros(4, 6),
            "empty": torch.zeros(0, 4, 6),
            "noncontiguous": x.transpose(1, 2),
            "bf16": x.bfloat16(),
            "int": x.int(),
        }[case]
        with pytest.raises(ValueError):
            k.stencil2d_apply(bad, diag=DIAG, off=OFF)
