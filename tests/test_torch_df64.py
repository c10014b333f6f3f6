"""Port parity for double-float arithmetic (``solvers/df64.py``) and the
double-float residual kernel's plain version.

Every function runs the JAX package's operation order on the same f32
inputs, so the results are held to equal bits.  The Pallas df residual
kernel runs in interpret mode (as ``tests/test_pallas.py`` runs it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.ops import stencil_pallas as sp
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64 as jdf
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64 as tdf


def _df_pair(shape, seed):
    """An f32 (hi, lo) pair with a lo part of realistic size, numpy."""
    rng = np.random.default_rng(seed)
    x64 = rng.standard_normal(shape) * rng.uniform(0.5, 8.0, shape)
    hi = x64.astype(np.float32)
    lo = (x64 - hi).astype(np.float32)
    return hi, lo


def _equal(t, j):
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  np.asarray(j).view(np.int32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


class TestResidualKernelPlainVersion:
    @pytest.mark.parametrize("shape", [(16, 16, 16), (16, 16, 32)])
    def test_bits_equal_pallas_kernel(self, shape):
        (xh, xl), (bh, bl) = _df_pair(shape, 1), _df_pair(shape, 2)
        with pltpu.force_tpu_interpret_mode():
            rj = sp.stencil3d_df_residual_pallas(
                *_j(xh, xl, bh, bl), nx=shape[0], ny=shape[1], nz=shape[2])
        rt = k.stencil3d_df_residual_plain(*_t(xh, xl, bh, bl), diag=6.0,
                                           off=-1.0)
        _equal(rt[0], rj[0])
        _equal(rt[1], rj[1])

    @pytest.mark.parametrize("diag,off", [(6.0, -1.0), (5.0, -1.0),
                                          (2.0, -2.0), (7.0, -3.0),
                                          (6.5, -0.75)])
    def test_bits_equal_reference_tree(self, diag, off):
        """Every coefficient route of kernel D (one or two powers of two,
        Dekker product, exact scaling) against the JAX EFT tree."""
        shape = (5, 6, 7)
        (xh, xl), (bh, bl) = _df_pair(shape, 3), _df_pair(shape, 4)
        pj = [jnp.pad(a, 1) for a in _j(xh, xl)]
        rj = jdf._df_residual_core_3d(*pj, *_j(bh, bl), diag, off)
        rt = k.stencil3d_df_residual_plain(*_t(xh, xl, bh, bl), diag=diag,
                                           off=off)
        _equal(rt[0], rj[0])
        _equal(rt[1], rj[1])

    def test_accuracy_against_f64(self):
        shape = (6, 7, 8)
        (xh, xl), (bh, bl) = _df_pair(shape, 5), _df_pair(shape, 6)
        rh, rl = k.stencil3d_df_residual_plain(*_t(xh, xl, bh, bl), diag=6.0,
                                               off=-1.0)
        x64 = xh.astype(np.float64) + xl
        b64 = bh.astype(np.float64) + bl
        op = tpoisson.poisson3d(*shape)
        ref = b64 - op.mv(torch.from_numpy(x64)).numpy()
        got = rh.double().numpy() + rl.double().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-12)

    @pytest.mark.parametrize("c,allow_scale,mode", [
        (6.0, False, (1, 4.0, 2.0)), (-1.0, True, (3, 0.0, 0.0)),
        (-1.0, False, (0, -1.0, 0.0)), (5.0, False, (1, 4.0, 1.0)),
        (7.0, False, (2, 0.0, 0.0)), (-3.0, True, (1, -2.0, -1.0))])
    def test_kernel_coefficient_plan(self, c, allow_scale, mode):
        """The host plan kernel D gets follows df64's decomposition."""
        assert k._coeff_mode(c, allow_scale) == (*mode, c)


class TestPrimitives:
    N = 4096

    def _ab(self):
        rng = np.random.default_rng(7)
        a = (rng.standard_normal(self.N) * 10.0 ** rng.integers(-4, 5, self.N))
        b = (rng.standard_normal(self.N) * 10.0 ** rng.integers(-4, 5, self.N))
        return a.astype(np.float32), b.astype(np.float32)

    def test_two_sum_and_adds(self):
        a, b = self._ab()
        (ja, jb), (ta, tb) = _j(a, b), _t(a, b)
        for t, j in zip(tdf.two_sum(ta, tb), jdf.two_sum(ja, jb)):
            _equal(t, j)
        for t, j in zip(tdf.df_add((ta, tb), (tb, ta)),
                        jdf.df_add((ja, jb), (jb, ja))):
            _equal(t, j)
        for t, j in zip(tdf.df_add_f32((ta, tb), ta),
                        jdf.df_add_f32((ja, jb), ja)):
            _equal(t, j)
        for t, j in zip(tdf.df_neg((ta, tb)), jdf.df_neg((ja, jb))):
            _equal(t, j)

    @pytest.mark.parametrize("s", [3.0, 0.1, 1234.5678, -7.25e-5])
    def test_df_mul_f32(self, s):
        a, b = self._ab()
        lo = (b * np.float32(1e-8)).astype(np.float32)
        st = torch.tensor(s, dtype=torch.float32)
        for t, j in zip(tdf.df_mul_f32(_t(a, lo), st),
                        jdf.df_mul_f32(_j(a, lo), jnp.float32(s))):
            _equal(t, j)

    @pytest.mark.parametrize("c", [6.0, 4.0, 3.0, 5.0, 7.0, -2.5, -1.0])
    def test_int_coeff_mul(self, c):
        a, _ = self._ab()
        for t, j in zip(tdf._int_coeff_mul(torch.from_numpy(a), c),
                        jdf._int_coeff_mul(jnp.asarray(a), c)):
            _equal(t, j)

    def test_scaled_norm(self):
        a, _ = self._ab()
        tiny = a * np.float32(1e-20)   # squares underflow f32
        for v in (a, tiny):
            got = float(tdf.scaled_norm(torch.from_numpy(v)))
            np.testing.assert_allclose(got, float(jdf.scaled_norm(jnp.asarray(v))),
                                       rtol=1e-6)
            np.testing.assert_allclose(got, np.linalg.norm(v.astype(np.float64)),
                                       rtol=1e-6)

    def test_f64_split_round_trip(self):
        x64 = np.random.default_rng(8).standard_normal((3, 4, 5)) / 3.0
        th, tl = tdf.df_from_f64(x64, "cpu")
        jh, jl = jdf.df_from_f64(x64)
        _equal(th, jh)
        _equal(tl, jl)
        np.testing.assert_array_equal(tdf.df_to_f64((th, tl)),
                                      jdf.df_to_f64((jh, jl)))
        np.testing.assert_allclose(tdf.df_to_f64((th, tl)), x64, rtol=1e-14)


def test_df_residual_for_operator():
    shape = (8, 8, 12)
    (xh, xl), (bh, bl) = _df_pair(shape, 9), _df_pair(shape, 10)
    rj = jdf.df_residual_for(jpoisson.poisson3d(*shape))(
        tuple(_j(bh, bl)), tuple(_j(xh, xl)))
    rt = tdf.df_residual_for(tpoisson.poisson3d(*shape))(
        tuple(_t(bh, bl)), tuple(_t(xh, xl)))
    _equal(rt[0], rj[0])
    _equal(rt[1], rj[1])
    with pytest.raises(TypeError):
        tdf.df_residual_for(object())
