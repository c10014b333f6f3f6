"""Port parity for the assembled sparse formats: ``DenseOp``, ``ELL``,
``DIA``, ``BSR`` and ``AIJ`` (``core/operators.py``), their host-side
packs, and the plain versions of kernels H (``ops/csr.py``) and I
(``ops/bsr.py``).

The same matrices, made with numpy from a seed, go through the JAX
package and the port on the CPU.  Packs must be equal exactly.  Products
agree to 1e-13 (f64, relative to the largest entry) and, where the JAX
side runs in f32 through a Pallas kernel in interpret mode, to JAX's own
tolerance (1e-4 for AIJ, whose routed sums run in another order; 2e-5
for BSR).  The CUDA kernels themselves run only on a card: there
``chip_smoke.py`` holds them against these plain versions.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.ops import aij_pallas
from medane_tchakorom_ufc_thesis_repository_tpu.ops.bsr_pallas import (
    bsr_mv_pallas,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import device as tdevice
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import operators as tops
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import bsr as tbsr
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import csr as tcsr

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

CPU = "cpu"


def _random_coo(seed, nrows, ncols, nnz):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, nrows, nnz), rng.randint(0, ncols, nnz),
            rng.randn(nnz))


def _dense(rows, cols, vals, shape):
    d = np.zeros(shape)
    np.add.at(d, (rows, cols), vals)
    return d


def _close(got, ref, rtol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, err


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


class TestDefaultDevice:
    def test_none_raises_without_a_card(self):
        assert not torch.cuda.is_available()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tdevice.default_device()

    @pytest.mark.parametrize("call", [
        lambda: tpoisson.rhs_for_exact_ones(tpoisson.poisson2d(4, 4)),
        lambda: tpoisson.poisson2d_dia(4, 4),
        lambda: tpoisson.poisson3d_ell(3, 3, 3),
        lambda: convert.tensor_from_numpy(np.ones(3)),
        lambda: tops.AIJ.from_coo([0], [0], [1.0], (2, 2)),
        lambda: tops.BSR.from_coo(np.arange(8), np.arange(8), np.ones(8),
                                  (8, 8), bs=8),
        lambda: tops.from_scipy(sp.eye(8, format="csr")),
        lambda: tops.BSR.from_coo(np.arange(8), np.arange(8), np.ones(8),
                                  (8, 8), bs=8, device=CPU).to(None),
    ])
    def test_entry_points_raise_without_a_card(self, call):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()

    def test_cpu_is_taken_when_asked(self):
        assert tdevice.resolve("cpu") == torch.device("cpu")
        b = tpoisson.rhs_for_exact_ones(tpoisson.poisson2d(4, 4),
                                        torch.float64, CPU)
        assert b.device.type == "cpu"


class TestPoissonBuilders:
    def test_coo_and_dense_3d(self):
        for got, ref in zip(tpoisson.poisson3d_coo(3, 4, 5),
                            jpoisson.poisson3d_coo(3, 4, 5)):
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tpoisson.poisson3d_dense_np(3, 4, 5),
                                      jpoisson.poisson3d_dense_np(3, 4, 5))

    @pytest.mark.parametrize("name,dims", [
        ("poisson2d_ell", (7, 5)), ("poisson2d_dia", (7, 5)),
        ("poisson3d_ell", (3, 4, 5)), ("poisson3d_dia", (3, 4, 5))])
    def test_packs_equal(self, name, dims):
        jop = getattr(jpoisson, name)(*dims, dtype=jnp.float64)
        top = getattr(tpoisson, name)(*dims, dtype=torch.float64, device=CPU)
        if name.endswith("ell"):
            np.testing.assert_array_equal(top.indices.numpy(),
                                          np.asarray(jop.indices))
            np.testing.assert_array_equal(top.values.numpy(),
                                          np.asarray(jop.values))
            assert top.ncols == jop.ncols and top.ndiags() == jop.ndiags()
        else:
            np.testing.assert_array_equal(top.data.numpy(),
                                          np.asarray(jop.data))
            assert top.offsets == jop.offsets
        assert top.shape == tuple(jop.shape) and top.nnz == jop.nnz


class TestPlainFormats:
    """``DenseOp``, ``ELL``, ``DIA``: ``mv``, ``rmv``, ``to_dense`` against
    JAX to 1e-13 in f64, one vector and a batch."""

    def _pair(self, kind):
        rows, cols, vals = _random_coo(5, 60, 60, 400)
        keep = np.unique(rows * 60 + cols, return_index=True)[1]
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        if kind == "dense":
            d = _dense(rows, cols, vals, (60, 45 + 15))[:, :45]
            return jops.DenseOp(a=jnp.asarray(d)), tops.DenseOp(a=_t(d))
        if kind == "ell":
            cols = cols % 45          # rectangular
            return (jpoisson.coo_to_ell(rows, cols, vals, (60, 45),
                                        dtype=jnp.float64),
                    tpoisson.coo_to_ell(rows, cols, vals, (60, 45),
                                        dtype=torch.float64, device=CPU))
        offs = np.array([-7, -1, 0, 2, 9])[rows % 5]
        cols = rows + offs
        ok = (cols >= 0) & (cols < 60)
        return (jpoisson.coo_to_dia(rows[ok], cols[ok], vals[ok], (60, 60),
                                    dtype=jnp.float64),
                tpoisson.coo_to_dia(rows[ok], cols[ok], vals[ok], (60, 60),
                                    dtype=torch.float64, device=CPU))

    @pytest.mark.parametrize("kind", ["dense", "ell", "dia"])
    def test_products_and_dense(self, kind):
        jop, top = self._pair(kind)
        assert type(top).__name__ == type(jop).__name__
        assert top.shape == tuple(jop.shape) and top.nnz == jop.nnz
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, top.shape[1]))
        y = rng.standard_normal((3, top.shape[0]))
        _close(top.to_dense().numpy(), jop.to_dense(), 1e-13)
        _close(top.mv(_t(x[0])).numpy(), jop.mv(jnp.asarray(x[0])), 1e-13)
        _close(top.rmv(_t(y[0])).numpy(), jop.rmv(jnp.asarray(y[0])), 1e-13)
        _close(top.mv(_t(x)).numpy(),
               np.stack([np.asarray(jop.mv(jnp.asarray(v))) for v in x]),
               1e-13)
        _close(top.rmv(_t(y)).numpy(),
               np.stack([np.asarray(jop.rmv(jnp.asarray(v))) for v in y]),
               1e-13)

    def test_ell_to_dia_and_coo(self):
        jop = jpoisson.poisson2d_ell(6, 5, dtype=jnp.float64)
        top = tpoisson.poisson2d_ell(6, 5, dtype=torch.float64, device=CPU)
        for got, ref in zip(top.to_coo_np(), jop.to_coo_np()):
            np.testing.assert_array_equal(got, ref)
        jd, td = jop.to_dia(), top.to_dia()
        assert td.offsets == jd.offsets
        np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
        with pytest.raises(ValueError, match="square"):
            tpoisson.coo_to_ell(np.array([0]), np.array([1]), np.ones(1),
                                (2, 3), device=CPU).to_dia()

    def test_convert_from_jax(self):
        for kind in ("dense", "ell", "dia"):
            jop, top = self._pair(kind)
            got = convert.from_jax_operator(jop, device=CPU)
            assert type(got) is type(top)
            x = _t(np.random.default_rng(2).standard_normal(top.shape[1]))
            np.testing.assert_array_equal(got.mv(x).numpy(),
                                          top.mv(x).numpy())


class TestBsr:
    def _matrix(self, n, density, seed, symmetric=False):
        A = sp.random(n, n, density=density, random_state=seed).tocsr()
        A = A + sp.eye(n)
        if symmetric:
            A = A + A.T
        return A.tocoo()

    @pytest.mark.parametrize("bs,n,symmetric", [
        (8, 96, False), (16, 96, False), (8, 100, False), (16, 90, True)])
    def test_pack_and_products_match_jax(self, bs, n, symmetric):
        coo = self._matrix(n, 0.1, 3, symmetric)
        jop = jops.BSR.from_coo(coo.row, coo.col, coo.data, coo.shape, bs=bs,
                                dtype=jnp.float64)
        top = tops.BSR.from_coo(coo.row, coo.col, coo.data, coo.shape, bs=bs,
                                dtype=torch.float64, device=CPU)
        for f in ("indices", "values", "indices_t", "values_t"):
            np.testing.assert_array_equal(getattr(top, f).numpy(),
                                          np.asarray(getattr(jop, f)))
        assert (top.values_t is top.values) == symmetric
        assert (jop.values_t is jop.values) == symmetric
        assert (top.bs, top.shape, top.nnz) == (jop.bs, tuple(jop.shape),
                                                jop.nnz)
        assert top.fill == pytest.approx(jop.fill, rel=1e-15)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((3, n))
        _close(top.to_dense().numpy(), jop.to_dense(), 1e-13)
        _close(top.to_dense().numpy(), coo.toarray(), 1e-13)
        _close(top.mv(_t(x[0])).numpy(), jop.mv(jnp.asarray(x[0])), 1e-13)
        _close(top.rmv(_t(x[0])).numpy(), jop.rmv(jnp.asarray(x[0])), 1e-13)
        _close(top.mv(_t(x)).numpy(), x @ coo.toarray().T, 1e-13)
        _close(top.rmv(_t(x)).numpy(), x @ coo.toarray(), 1e-13)
        moved = top.to(CPU)
        assert (moved.values_t is moved.values) == symmetric

    @pytest.mark.parametrize("bs", [8, 16])
    def test_plain_matches_pallas_kernel_f32(self, bs):
        """As ``tests/test_pallas.py`` runs ``bsr_mv_pallas``: under the
        TPU interpreter, f32, 2e-5."""
        coo = self._matrix(96, 0.1, 3)
        jop = jops.BSR.from_coo(coo.row, coo.col, coo.data, coo.shape, bs=bs,
                                dtype=jnp.float32)
        top = convert.from_jax_operator(jop, device=CPU)
        x = np.random.default_rng(3).standard_normal(96).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(bsr_mv_pallas(jop, jnp.asarray(x)))
        got = tbsr.bsr_mv_plain(top.indices, top.values, torch.from_numpy(x),
                                96, 96).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(top.mv(torch.from_numpy(x)).numpy(), got)

    def test_wrapper_refuses_what_the_kernel_does_not_take(self):
        idx = torch.zeros((2, 1), dtype=torch.int32)
        val = torch.zeros((2, 1, 8, 8), dtype=torch.float64)
        x = torch.zeros(16, dtype=torch.float64)
        with pytest.raises(ValueError, match="int32"):
            tbsr.bsr_mv(idx.long(), val, x, 16, 16)
        with pytest.raises(ValueError, match="share"):
            tbsr.bsr_mv(idx, val, x.float(), 16, 16)
        with pytest.raises(ValueError, match="block size"):
            tbsr.bsr_mv(idx, torch.zeros((2, 1, 4, 4), dtype=torch.float64),
                        x[:8], 8, 8)
        with pytest.raises(ValueError, match="x must be"):
            tbsr.bsr_mv(idx, val, x[:15], 16, 16)


class TestAij:
    def test_square_matches_jax_and_dense(self):
        """``tests/test_aij.py``'s square case: f32 against JAX's ``AIJ.mv``
        and the Pallas kernels in interpret mode (1e-4), f64 against the
        dense product (1e-12)."""
        rows, cols, vals = _random_coo(21, 2500, 2500, 20000)
        jop = jops.AIJ.from_coo(rows, cols, vals, (2500, 2500),
                                with_rmv=False)
        top = convert.aij_from_coo(rows, cols, vals, (2500, 2500),
                                   with_rmv=False, device=CPU)
        assert top.nnz == jop.nnz == len(np.unique(rows * 2500 + cols))
        assert top.shape == tuple(jop.shape) and top.fill == 1.0
        x = np.random.RandomState(1).randn(2500).astype(np.float32)
        got = top.mv(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jop.mv(jnp.asarray(x))),
                                   rtol=1e-4, atol=1e-4)
        pallas = aij_pallas.aij_mv_pallas(jop.segments, jop.n_pad_cols,
                                          jop.nrows, jnp.asarray(x),
                                          interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4,
                                   atol=1e-4)
        with pytest.raises(ValueError, match="with_rmv=False"):
            top.rmv(torch.from_numpy(x))
        t64 = tops.AIJ.from_coo(rows, cols, vals, (2500, 2500),
                                dtype=torch.float64, device=CPU)
        d = _dense(rows, cols, vals, (2500, 2500))
        xb = np.random.RandomState(2).randn(3, 2500)
        _close(t64.mv(_t(xb)).numpy(), xb @ d.T, 1e-12)
        _close(t64.rmv(_t(xb)).numpy(), xb @ d, 1e-12)
        _close(t64.to_dense().numpy(), d, 1e-15)

    def test_multi_segment_pattern(self):
        """The JAX pack splits this one into at least 3 segments."""
        rows, cols, vals = _random_coo(22, 3000, 3000, 18000)
        jop = jops.AIJ.from_coo(rows, cols, vals, (3000, 3000),
                                with_rmv=False, target_nnz=7000)
        assert len(jop.segments) >= 3
        top = convert.aij_from_coo(rows, cols, vals, (3000, 3000),
                                   with_rmv=False, device=CPU)
        x = np.random.RandomState(3).randn(3000).astype(np.float32)
        got = top.mv(torch.from_numpy(x)).numpy()
        pallas = aij_pallas.aij_mv_pallas(jop.segments, jop.n_pad_cols,
                                          jop.nrows, jnp.asarray(x),
                                          interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4,
                                   atol=1e-4)
        want = _dense(rows, cols, vals, (3000, 3000)).astype(np.float32) @ x
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_rectangular_with_rmv(self):
        rows, cols, vals = _random_coo(12, 2000, 1500, 12000)
        jop = jops.AIJ.from_coo(rows, cols, vals, (2000, 1500))
        top = tops.AIJ.from_coo(rows, cols, vals, (2000, 1500), device=CPU)
        assert top.t_data is not top.data
        rng = np.random.RandomState(4)
        x = rng.randn(1500).astype(np.float32)
        y = rng.randn(2000).astype(np.float32)
        np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(),
                                   np.asarray(jop.mv(jnp.asarray(x))),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(top.rmv(torch.from_numpy(y)).numpy(),
                                   np.asarray(jop.rmv(jnp.asarray(y))),
                                   rtol=1e-4, atol=1e-4)
        t64 = tops.AIJ.from_coo(rows, cols, vals, (2000, 1500),
                                dtype=torch.float64, device=CPU)
        d = _dense(rows, cols, vals, (2000, 1500))
        _close(t64.rmv(_t(y.astype(np.float64))).numpy(), d.T @ y, 1e-12)

    def test_symmetric_shares_arrays_and_empty_rows(self):
        rows, cols, vals = _random_coo(6, 300, 300, 900)
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        vals = np.concatenate([vals, vals])
        top = tops.AIJ.from_coo(rows, cols, vals, (300, 300),
                                dtype=torch.float64, device=CPU)
        assert top.t_data is top.data and top.t_indptr is top.indptr
        moved = top.to(CPU)
        assert moved.t_data is moved.data
        one = tops.AIJ.from_coo(np.array([500]), np.array([900]),
                                np.array([2.0]), (2000, 2000),
                                dtype=torch.float64, device=CPU)
        want = np.zeros(2000)
        want[500] = 2.0
        np.testing.assert_array_equal(
            one.mv(torch.ones(2000, dtype=torch.float64)).numpy(), want)

    def test_plain_kernel_form(self):
        """``csr_mv_plain`` on raw CSR arrays, and the chunk rule."""
        a = sp.random(40, 30, density=0.2, random_state=8).tocsr()
        a.sort_indices()
        x = np.random.default_rng(9).standard_normal((2, 30))
        got = tcsr.csr_mv_plain(torch.from_numpy(a.indptr.astype(np.int32)),
                                torch.from_numpy(a.indices.astype(np.int32)),
                                torch.from_numpy(a.data), _t(x), 40)
        _close(got.numpy(), x @ a.toarray().T, 1e-14)
        c = tcsr.CHUNK
        assert [tcsr.csr_blocks(nnz) for nnz in
                (0, 1, c, c + 1, 10 * c)] == [1, 1, 1, 2, 10]
        assert tcsr.csr_partition(torch.from_numpy(
            a.indptr.astype(np.int32)), a.nnz).tolist() == [0, 40]
        with pytest.raises(ValueError, match="int32"):
            tcsr.csr_mv(torch.from_numpy(a.indptr.astype(np.int64)),
                        torch.from_numpy(a.indices.astype(np.int32)),
                        torch.from_numpy(a.data), _t(x), 40)

    def test_vector_length_is_held_to_the_matrix(self):
        """A vector of another length than the matrix's columns (rows, for
        ``rmv``) is refused before any gather."""
        rows, cols, vals = _random_coo(10, 50, 40, 200)
        op = tops.AIJ.from_coo(rows, cols, vals, (50, 40),
                               dtype=torch.float64, device=CPU)
        with pytest.raises(ValueError, match="40 columns"):
            op.mv(torch.ones(39, dtype=torch.float64))
        with pytest.raises(ValueError, match="50 columns"):
            op.rmv(torch.ones((2, 51), dtype=torch.float64))
        with pytest.raises(ValueError, match="40 columns"):
            tcsr.csr_mv(op.indptr, op.indices, op.data,
                        torch.ones(64, dtype=torch.float64), 50, 40)
        assert op.mv(torch.ones(40, dtype=torch.float64)).shape == (50,)
        assert op.rmv(torch.ones((2, 50), dtype=torch.float64)).shape == (2, 40)
