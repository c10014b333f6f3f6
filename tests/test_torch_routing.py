"""Port parity for the operator routing: ``operator_from_coo``,
``from_scipy``, ``as_routed_operator`` (the twin of the JAX package's
``as_tpu_operator``) and the calibration store they read.

The port ships constants measured on its own card, so its decisions may
differ from the JAX package's.  Here the port's table is set to the JAX
package's shipped values, and then both must return the same class, block
size and warning for a banded, a blockable, a small unstructured, a
high-fill, a large structureless and a rectangular matrix (the cases of
``tests/test_bsr.py``), and the routed operator must multiply like the
matrix (1e-12, f64).
"""

import json
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import calibration as jcal
from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import calibration as tcal
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import operators as tops
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson

CPU = "cpu"


@pytest.fixture()
def jax_table(monkeypatch):
    """The port's calibration set to the JAX package's shipped table."""
    monkeypatch.delenv("MEDANE_TORCH_CALIBRATION", raising=False)
    monkeypatch.setattr(tcal, "_loaded", {
        k: (dict(v) if isinstance(v, dict) else v)
        for k, v in jcal.SHIPPED.items()})
    jcal.reset_cache()
    yield
    jcal.reset_cache()


def _random_block_sparse(nb, bs, blocks_per_row, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    n = nb * bs
    A = sp.lil_matrix((n, n))
    for r in range(nb):
        for c in rng.choice(nb, size=min(blocks_per_row, nb), replace=False):
            A[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = (
                rng.standard_normal((bs, bs)))
    A = A.tocsr()
    if spd:
        A = (A @ A.T).tocsr() + sp.eye(n) * n
    return A


def _unstructured(density, seed=23, n=256):
    return (sp.random(n, n, density=density, random_state=seed).tocsr()
            + sp.eye(n)).tocsr()


def _ells(A):
    coo = A.tocoo()
    return (jpoisson.coo_to_ell(coo.row, coo.col, coo.data, coo.shape,
                                dtype=jnp.float64),
            tpoisson.coo_to_ell(coo.row, coo.col, coo.data, coo.shape,
                                dtype=torch.float64, device=CPU))


def _same_route(jout, tout, A):
    assert type(tout).__name__ == type(jout).__name__
    if isinstance(tout, tops.BSR):
        assert tout.bs == jout.bs
        np.testing.assert_array_equal(tout.indices.numpy(),
                                      np.asarray(jout.indices))
    x = np.random.default_rng(3).standard_normal(A.shape[1])
    np.testing.assert_allclose(tout.mv(torch.from_numpy(x)).numpy(), A @ x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.usefixtures("jax_table")
class TestAsRoutedOperator:
    def test_banded_goes_dia(self):
        jell = jpoisson.poisson2d_ell(16, 16, dtype=jnp.float64)
        tell = tpoisson.poisson2d_ell(16, 16, dtype=torch.float64, device=CPU)
        jout, tout = jops.as_tpu_operator(jell), tops.as_routed_operator(tell)
        assert isinstance(tout, tops.DIA) and isinstance(jout, jops.DIA)
        assert tout.offsets == jout.offsets

    def test_blockable_goes_bsr(self):
        A = _random_block_sparse(nb=4, bs=16, blocks_per_row=2, seed=21)
        jell, tell = _ells(A)
        kw = dict(max_diags=8, bsr_block_sizes=(16,), max_bsr_cost=40.0)
        _same_route(jops.as_tpu_operator(jell, **kw),
                    tops.as_routed_operator(tell, **kw), A)

    def test_block_size_choice_matches(self):
        A = _random_block_sparse(nb=6, bs=16, blocks_per_row=2, seed=31,
                                 spd=True)
        jell, tell = _ells(A)
        kw = dict(max_diags=8, max_bsr_cost=64.0)
        jout = jops.as_tpu_operator(jell, **kw)
        tout = tops.as_routed_operator(tell, **kw)
        assert isinstance(tout, tops.BSR)
        _same_route(jout, tout, A)

    def test_unblockable_routes_aij(self):
        A = _unstructured(0.002)
        jell, tell = _ells(A)
        kw = dict(max_diags=8, max_bsr_cost=4.0, bsr_block_sizes=(128,),
                  max_dense_n=0, max_bsr_bytes=1024)
        jout = jops.as_tpu_operator(jell, **kw)
        tout = tops.as_routed_operator(tell, **kw)
        assert isinstance(tout, tops.AIJ)
        _same_route(jout, tout, A)

    def test_highfill_bsr_against_the_aij_bar(self, monkeypatch, tmp_path):
        A = _unstructured(0.02)
        jell, tell = _ells(A)
        kw = dict(max_diags=8, max_bsr_cost=4.0, bsr_block_sizes=(128,),
                  max_dense_n=0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            jout = jops.as_tpu_operator(jell, **kw)
            tout = tops.as_routed_operator(tell, **kw)
        assert isinstance(tout, tops.AIJ)
        _same_route(jout, tout, A)
        # with the AIJ bar raised (a calibration file), the high-fill BSR
        # branch fires in both, with the same warning
        jpath, tpath = tmp_path / "jcal.json", tmp_path / "tcal.json"
        monkeypatch.setenv("MEDANE_TPU_CALIBRATION", str(jpath))
        monkeypatch.setenv("MEDANE_TORCH_CALIBRATION", str(tpath))
        jcal.save({"aij_relative_cost": 1950.0})
        tcal.save({**{k: v for k, v in jcal.SHIPPED.items()},
                   "aij_relative_cost": 1950.0})
        try:
            with pytest.warns(UserWarning, match="HIGH-fill BSR") as jw:
                jout = jops.as_tpu_operator(jell, **kw)
            with pytest.warns(UserWarning, match="HIGH-fill BSR") as tw:
                tout = tops.as_routed_operator(tell, **kw)
            assert isinstance(tout, tops.BSR)
            _same_route(jout, tout, A)
            assert str(tw[0].message) == str(jw[0].message).replace(
                "as_tpu_operator", "as_routed_operator")
        finally:
            jcal.reset_cache()
            tcal.reset_cache()

    def test_small_unstructured_routes_dense(self):
        A = _unstructured(0.02)
        jell, tell = _ells(A)
        kw = dict(max_diags=8, max_bsr_cost=4.0, bsr_block_sizes=(128,))
        jout = jops.as_tpu_operator(jell, **kw)
        tout = tops.as_routed_operator(tell, **kw)
        assert isinstance(tout, tops.DenseOp)
        _same_route(jout, tout, A)
        y = np.random.default_rng(5).standard_normal(256)
        np.testing.assert_allclose(tout.rmv(torch.from_numpy(y)).numpy(),
                                   A.T @ y, rtol=1e-12)

    def test_other_operators_pass_through(self):
        op = tpoisson.poisson2d_dia(4, 4, device=CPU)
        assert tops.as_routed_operator(op) is op
        rect = tpoisson.coo_to_ell(np.array([0]), np.array([2]), np.ones(1),
                                   (2, 3), device=CPU)
        assert tops.as_routed_operator(rect) is rect


@pytest.mark.usefixtures("jax_table")
class TestFromScipy:
    def _both(self, A, **kw):
        return (jops.from_scipy(A, dtype=jnp.float64, **kw),
                tops.from_scipy(A, dtype=torch.float64, device=CPU, **kw))

    def test_banded_routes_dia(self):
        rows, cols, vals, shape = jpoisson.poisson2d_coo(16, 16)
        A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
        jout, tout = self._both(A)
        assert isinstance(tout, tops.DIA)
        _same_route(jout, tout, A)

    def test_blocky_routes_bsr_and_symmetric_shares_buffers(self):
        A = _random_block_sparse(nb=6, bs=16, blocks_per_row=2, seed=31,
                                 spd=True)
        jout, tout = self._both(A, bsr_block_sizes=(16,), max_bsr_cost=64.0)
        assert isinstance(tout, tops.BSR)
        assert tout.values_t is tout.values and tout.indices_t is tout.indices
        _same_route(jout, tout, A)

    def test_rectangular_small_dense_large_aij(self):
        A = sp.random(30, 50, density=0.1, random_state=41).tocsr()
        jout, tout = self._both(A)
        assert isinstance(tout, tops.DenseOp)
        _same_route(jout, tout, A)
        jout, tout = self._both(A, max_dense_n=0)
        assert isinstance(tout, tops.AIJ)
        _same_route(jout, tout, A)
        y = np.random.default_rng(5).standard_normal(30)
        np.testing.assert_allclose(tout.rmv(torch.from_numpy(y)).numpy(),
                                   A.T @ y, rtol=1e-12, atol=1e-12)

    def test_large_structureless_routes_aij_without_warning(self):
        n = 1500
        B = sp.random(n, n, density=0.003, random_state=1)
        A = ((B + B.T) * 0.5 + sp.eye(n) * 5.0).tocsr()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            jout, tout = self._both(A, max_dense_n=1024)
        assert isinstance(tout, tops.AIJ) and isinstance(jout, jops.AIJ)
        assert tout.nnz == jout.nnz == A.nnz
        assert tout.t_data is tout.data      # symmetric: shared arrays
        _same_route(jout, tout, A)

    def test_dense_route_coalesces_coo_duplicates(self):
        rows = np.array([0, 0, 1, 2, 0])
        cols = np.array([0, 1, 2, 0, 0])
        vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
        op = tops.operator_from_coo(rows, cols, vals, (3, 3),
                                    dtype=torch.float64, max_diags=0,
                                    max_bsr_cost=0.0, device=CPU)
        assert isinstance(op, tops.DenseOp)
        np.testing.assert_array_equal(
            op.to_dense().numpy(),
            np.array([[6.0, 2.0, 0.0], [0.0, 0.0, 3.0], [4.0, 0.0, 0.0]]))

    @pytest.mark.parametrize("bs", [8, 16, 32])
    def test_fill_estimate_matches_and_counts_padding(self, bs):
        n = 64
        rows = np.concatenate([np.arange(n), np.zeros(n, np.int64)])
        cols = np.concatenate([np.arange(n), np.arange(n)])
        fill = tops.bsr_block_fill_from_coo(rows, cols, (n, n), bs)
        assert fill == jops.bsr_block_fill_from_coo(rows, cols, (n, n), bs)
        if bs == 8:   # 8 block rows x width 8 x 64 stored values
            assert fill == pytest.approx(4096 / len(rows))
        coo = _unstructured(0.02).tocoo()
        assert tops.bsr_block_fill_from_coo(
            coo.row, coo.col, coo.shape, bs) == jops.bsr_block_fill_from_coo(
            coo.row, coo.col, coo.shape, bs)

    def test_closures(self):
        op = tpoisson.poisson2d_dia(4, 4, device=CPU)
        assert tops.as_matvec(op) == op.mv and tops.as_rmatvec(op) == op.rmv


class TestCalibrationStore:
    def test_shipped_table_is_the_cards_own(self):
        """Four constants under the JAX package's names; the values were
        measured on the port's card and are not the JAX package's."""
        assert set(tcal.SHIPPED) == set(jcal.SHIPPED)
        assert set(tcal.SHIPPED["bsr_bs_penalty"]) == {8, 16, 32, 64, 128}
        assert tcal.SHIPPED != jcal.SHIPPED
        assert all(v > 0 for v in tcal.SHIPPED["bsr_bs_penalty"].values())
        assert tcal.SHIPPED["aij_relative_cost"] > 0
        assert tcal.SHIPPED["ell_relative_cost"] > 0
        assert tcal.SHIPPED["max_dense_n"] >= 0

    def test_lookup_order_and_save(self, monkeypatch, tmp_path):
        monkeypatch.delenv("MEDANE_TORCH_CALIBRATION", raising=False)
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        tcal.reset_cache()
        try:
            assert tcal.calibration_path("H100") == str(
                tmp_path / "medane_tchakorom_ufc_thesis_repository_tpu_torch"
                / "calibration-H100.json")
            assert tcal.load()["max_dense_n"] == tcal.SHIPPED["max_dense_n"]
            assert "source" not in tcal.load()
            path = tmp_path / "cal.json"
            monkeypatch.setenv("MEDANE_TORCH_CALIBRATION", str(path))
            assert tcal.save({"max_dense_n": 77, "aij_relative_cost": 3.5,
                              "bsr_bs_penalty": {"8": 2.0}}) == str(path)
            assert json.loads(path.read_text())["max_dense_n"] == 77
            assert tcal.default_max_dense_n() == 77
            assert tcal.aij_relative_cost() == 3.5
            assert tcal.bsr_bs_penalty() == {8: 2.0}
            assert tcal.ell_relative_cost() == tcal.SHIPPED["ell_relative_cost"]
            assert tcal.load()["source"] == str(path)
            path.write_text("not json")
            tcal.reset_cache()
            with pytest.warns(UserWarning, match="unreadable"):
                assert tcal.default_max_dense_n() == tcal.SHIPPED["max_dense_n"]
        finally:
            tcal.reset_cache()
