"""Port parity for the native host library (``native``): the g++-built
assembly (Poisson ELL/DIA planes, COO to ELL, the counting-sort BSR pack)
against the JAX package's ``native`` on the same numpy inputs, and the
BSR pack against the port's plain pack (``core/operators._bsr_pack_plain``).

Every comparison is bit for bit.  The port's ``assembly.cpp`` sorts each
block row with ``std::stable_sort`` (JAX's copy: ``std::sort``), so it
sums the duplicates of an entry in input order, as the plain pack's
``np.bincount`` and JAX's numpy pack (``np.add.at``) do.  JAX's native
pack is bit-equal where no entry repeats more than twice (two addends
commute); where entries repeat three times and more in block rows of
more than 16 entries, its unstable sort can reorder the addends, and it
is held to the last bits of f64 there (``TestPackAgainstJaxNative``).
"""

import threading
import unittest.mock as mock
from pathlib import Path

import numpy as np
import pytest
import torch

from medane_tchakorom_ufc_thesis_repository_tpu import native as jnative
from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu_torch import native
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import (
    operators as tops,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)


def _coo(n_r, n_c, nnz, seed, dup=0, rows=None):
    """``nnz`` distinct random positions (of the rows ``rows``, default
    all) and ``dup`` extra entries at the first of them: no entry more
    than twice."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n_r) if rows is None else np.asarray(rows)
    flat = rng.choice(len(rows) * n_c, nnz, replace=False)
    r, c = rows[flat // n_c], flat % n_c
    v = rng.standard_normal(nnz)
    r, c = np.concatenate([r, r[:dup]]), np.concatenate([c, c[:dup]])
    return r, c, np.concatenate([v, rng.standard_normal(dup)])


def _repeated(n_r, n_c, nnz, seed):
    """Each entry repeated 1 to 5 times, shuffled: three or more addends
    of one entry in block rows of far more than 16 entries."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n_r, nnz), rng.integers(0, n_c, nnz)
    rep = rng.integers(1, 6, nnz)
    r, c = np.repeat(r, rep), np.repeat(c, rep)
    v = rng.standard_normal(len(r))
    p = rng.permutation(len(r))
    return r[p], c[p], v[p]


# (shape, bs, coo): each entry at most twice
PACK_CASES = {
    "duplicates": ((64, 64), 8, _coo(64, 64, 300, 1, dup=5)),
    "empty block rows": ((64, 64), 8,
                         _coo(64, 64, 200, 2, dup=3,
                              rows=np.r_[0:16, 48:64])),
    "bs not dividing n": ((37, 53), 8, _coo(37, 53, 500, 3, dup=5)),
    "rectangular tall": ((128, 96), 32, _coo(128, 96, 5000, 4, dup=9)),
    "rectangular wide": ((40, 200), 16, _coo(40, 200, 900, 5, dup=5)),
    "no entries": ((16, 16), 8, _coo(16, 16, 0, 6)),
}
REPEATED = {"repeated 1-5 times": ((64, 64), 8, _repeated(64, 64, 400, 0)),
            "repeated, bs 16": ((96, 80), 16, _repeated(96, 80, 600, 1))}


def _jax_numpy_pack(r, c, v, shape, bs):
    """JAX's numpy pack (``np.unique`` and ``np.add.at``: input order),
    with its native pack switched off."""
    with mock.patch.object(jnative, "bsr_pack", lambda *a, **k: None):
        return jops._bsr_pack_np(r, c, v, shape, bs)


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype


class TestBuild:
    def test_library_builds_into_build_native(self):
        lib = native.load()
        path = native.library_path("assembly")
        root = Path(native.__file__).resolve().parents[2]
        assert path.parent == root / "build" / "native"
        assert path.is_file() and lib is native.load()

    def test_no_library_in_the_package(self):
        native.load()
        native.load_comm()
        pkg = Path(native.__file__).resolve().parents[1]
        assert not list(pkg.rglob("*.so"))

    def test_name_carries_source_flags_and_target(self, monkeypatch):
        before = native.library_path("assembly")
        monkeypatch.setitem(native.FLAGS, "assembly",
                            native.FLAGS["assembly"] + ("-g",))
        assert native.library_path("assembly") != before
        monkeypatch.setattr(native, "_target", lambda: b"another cpu")
        assert native.library_path("comm").name.startswith("libcomm-")

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        bad = tmp_path / "assembly.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SRC", tmp_path)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
        monkeypatch.setattr(native, "_libs", {})
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.load()
        assert not list((tmp_path / "out").glob("*"))

    def test_threads_build_once(self, monkeypatch, tmp_path):
        real = native.library_path("assembly")
        native.load()
        built = []

        def fake_compile(name, out):
            built.append(name)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(real.read_bytes())

        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(native, "_compile", fake_compile)
        monkeypatch.setattr(native, "_libs", {})
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(native.load()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert built == ["assembly"]
        assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


class TestAssemblyAgainstJax:
    @pytest.mark.parametrize("m,n", [(13, 9), (1, 7), (32, 32)])
    def test_poisson2d_ell(self, m, n):
        _equal(native.poisson2d_ell_np(m, n), jnative.poisson2d_ell_np(m, n))

    @pytest.mark.parametrize("dims", [(5, 4, 3), (2, 2, 9)])
    def test_poisson3d_ell(self, dims):
        _equal(native.poisson3d_ell_np(*dims), jnative.poisson3d_ell_np(*dims))

    @pytest.mark.parametrize("m,n", [(7, 6), (16, 3)])
    def test_poisson2d_dia(self, m, n):
        data, offs = native.poisson2d_dia_np(m, n)
        jdata, joffs = jnative.poisson2d_dia_np(m, n)
        assert tuple(offs) == tuple(joffs)
        np.testing.assert_array_equal(data, jdata)

    def test_poisson3d_dia(self):
        data, offs = native.poisson3d_dia_np(4, 3, 5)
        jdata, joffs = jnative.poisson3d_dia_np(4, 3, 5)
        assert tuple(offs) == tuple(joffs)
        np.testing.assert_array_equal(data, jdata)

    def test_coo_to_ell_general(self):
        rng = np.random.default_rng(0)
        n = 50
        pairs = np.unique(np.stack([rng.integers(0, n, 200),
                                    rng.integers(0, n, 200)]), axis=1)
        rows, cols = pairs[0], pairs[1]
        perm = rng.permutation(len(rows))    # unsorted input
        rows, cols = rows[perm], cols[perm]
        vals = rng.standard_normal(len(rows))
        width = int(np.bincount(rows, minlength=n).max())
        _equal(native.coo_to_ell_np(rows, cols, vals, n, width),
               jnative.coo_to_ell_np(rows, cols, vals, n, width))

    def test_coo_to_ell_width_overflow(self):
        rows, cols, vals = np.array([0, 0, 0]), np.array([0, 1, 2]), np.ones(3)
        with pytest.raises(ValueError, match="width 2"):
            native.coo_to_ell_np(rows, cols, vals, 2, 2)
        with pytest.raises(ValueError, match="width 2"):
            jnative.coo_to_ell_np(rows, cols, vals, 2, 2)


class TestPack:
    @pytest.mark.parametrize("case", list(PACK_CASES) + list(REPEATED))
    def test_native_equals_plain_and_jax_numpy(self, case):
        shape, bs, (r, c, v) = {**PACK_CASES, **REPEATED}[case]
        got = native.bsr_pack(r, c, v, shape, bs)
        _equal(got, tops._bsr_pack_plain(r, c, v, shape, bs))
        _equal(got, _jax_numpy_pack(r, c, v, shape, bs))

    @pytest.mark.parametrize("case", list(PACK_CASES))
    def test_native_equals_jax_native(self, case):
        shape, bs, (r, c, v) = PACK_CASES[case]
        _equal(native.bsr_pack(r, c, v, shape, bs),
               jnative.bsr_pack(r, c, v, shape, bs))

    def test_operators_pack_with_the_native_pack(self):
        shape, bs, (r, c, v) = PACK_CASES["bs not dividing n"]
        with mock.patch.object(native, "bsr_pack",
                               wraps=native.bsr_pack) as spy:
            op = tops.BSR.from_coo(r, c, v, shape, bs=bs,
                                   dtype=torch.float64, device="cpu")
        assert spy.call_count == 2          # A and A^T
        i, vals = tops._bsr_pack_plain(r, c, v, shape, bs)
        assert torch.equal(op.indices, torch.from_numpy(i))
        assert torch.equal(op.values, torch.from_numpy(vals))

    @pytest.mark.parametrize("rows,cols", [([99], [0]), ([0], [-1]),
                                           ([0], [100]), ([-1], [0])])
    def test_out_of_range_raises(self, rows, cols):
        for pack in (native.bsr_pack, jnative.bsr_pack):
            with pytest.raises(ValueError, match="outside"):
                pack(np.array(rows), np.array(cols), np.array([1.0]), (8, 8),
                     8)


class TestPackAgainstJaxNative:
    @pytest.mark.parametrize("case", list(REPEATED))
    def test_repeated_entries(self, case):
        """JAX's ``std::sort`` may sum three or more duplicates in another
        order: the same indices, values to the rounding of those sums."""
        shape, bs, (r, c, v) = REPEATED[case]
        got = native.bsr_pack(r, c, v, shape, bs)
        ref = jnative.bsr_pack(r, c, v, shape, bs)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=0,
                                   atol=8 * np.finfo(np.float64).eps)
