"""Port parity for the general sparse path of the multisplitting drivers:
the block split (``core/poisson.block_split_ell``), the stacked ELL, DIA
and BSR operators and their router (``models/blockops.py``), the strip
operators, and their conversion from the JAX package.

Both packages take the same numpy COO triplets, in f64 on the CPU.  The
split's planes must be equal to JAX's in every bit; every hook of a
stacked operator must agree with JAX's to 1e-12 relative, on one stack
``(nb, bs)`` and on a panel ``(s, nb, bs)`` (JAX takes a panel one
column at a time); the router must choose the same class, sub-block size,
width and warning under the JAX package's calibration table
(``test_torch_routing.jax_table``).  On the CPU the products of the
stacked ELL and BSR operators run the plain versions of kernels H and I.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as jops
from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops as tbo

from test_torch_routing import jax_table  # noqa: F401  (fixture)

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

CPU = "cpu"


# ---------------------------------------------------------------------------
# Matrices (the patterns of tests/test_inner_bjacobi.py, test_bsr.py and
# test_multisplitting.py), as COO triplets
# ---------------------------------------------------------------------------

def _coo(A):
    c = A.tocoo()
    return c.row, c.col, c.data, c.shape


def _poisson(m=16, n=16):
    return jpoisson.poisson2d_coo(m, n)


def _permuted(m=12, n=12, seed=29):
    rows, cols, vals, shape = jpoisson.poisson2d_coo(m, n)
    perm = np.random.default_rng(seed).permutation(shape[0])
    return perm[rows], perm[cols], vals, shape


def _variable_coeff(m=16, n=16):
    rows, cols, vals, shape = jpoisson.poisson2d_coo(m, n)
    scale = 1.0 + (np.arange(shape[0]) % 7) * 0.3
    return rows, cols, vals * scale[rows], shape


def _block_ill(nbk=16, bsk=16, seed=31, coupling=1e-2):
    rng = np.random.default_rng(seed)
    n = nbk * bsk
    A = sp.lil_matrix((n, n))
    for k in range(nbk):
        Q, _ = np.linalg.qr(rng.standard_normal((bsk, bsk)))
        lam = np.logspace(0, 3, bsk)
        A[k * bsk:(k + 1) * bsk, k * bsk:(k + 1) * bsk] = (Q * lam) @ Q.T
    C = sp.random(n, n, density=0.02, random_state=seed + 1)
    return _coo((A.tocsr() + coupling * (C + C.T)).tocsr())


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


def _blocky():
    return _coo(_random_block_sparse(8, 8, 2, seed=51, spd=True))


def _unbanded_blockable(seed=41, nbr=16, c=16):
    rng = np.random.default_rng(seed)
    n = nbr * c
    A = sp.lil_matrix((n, n))
    for k in range(nbr):
        A[k * c:(k + 1) * c, k * c:(k + 1) * c] = (
            rng.standard_normal((c, c)) + np.eye(c) * 8.0)
        j = (k + 1 + (k % 7)) % nbr
        A[k * c:(k + 1) * c, j * c:(j + 1) * c] = (
            0.1 * rng.standard_normal((c, c)))
    return _coo(A.tocsr())


PATTERNS = {"poisson": _poisson, "permuted": _permuted,
            "variable_coeff": _variable_coeff, "block_ill": _block_ill}


def _ell_pair(coo, nblocks=2):
    rows, cols, vals, shape = coo
    ja, jc = jpoisson.block_split_ell(rows, cols, vals, shape,
                                      nblocks=nblocks, dtype=jnp.float64)
    ta, tc = tpoisson.block_split_ell(rows, cols, vals, shape,
                                      nblocks=nblocks, dtype=torch.float64,
                                      device=CPU)
    return (jbo.StackedELLOperator(a_ii=ja, a_ic=jc),
            tbo.StackedELLOperator(a_ii=ta, a_ic=tc))


# ---------------------------------------------------------------------------
# The block split
# ---------------------------------------------------------------------------

class TestBlockSplit:
    @pytest.mark.parametrize("dtype", ["f64", "f32"])
    @pytest.mark.parametrize("nblocks", [2, 4])
    @pytest.mark.parametrize("pattern", sorted(PATTERNS))
    def test_planes_equal_jax(self, pattern, nblocks, dtype):
        rows, cols, vals, shape = PATTERNS[pattern]()
        jd, td = {"f64": (jnp.float64, torch.float64),
                  "f32": (jnp.float32, torch.float32)}[dtype]
        jparts = jpoisson.block_split_ell(rows, cols, vals, shape,
                                          nblocks=nblocks, dtype=jd)
        tparts = tpoisson.block_split_ell(rows, cols, vals, shape,
                                          nblocks=nblocks, dtype=td,
                                          device=CPU)
        for j, t in zip(jparts, tparts):
            assert t.ncols == j.ncols
            assert t.indices.dtype == torch.int32 and t.values.dtype == td
            np.testing.assert_array_equal(t.indices.numpy(),
                                          np.asarray(j.indices))
            np.testing.assert_array_equal(t.values.numpy(),
                                          np.asarray(j.values))

    def test_coo_like_to_padded(self):
        """Unsorted triplets with duplicates and empty rows: the same slot
        order (stable) and width; and triplets already in order."""
        rng = np.random.default_rng(3)
        r = rng.integers(0, 9, 60)
        c = rng.integers(0, 20, 60)
        v = rng.standard_normal(60)
        r[r == 4] = 5                       # row 4 empty
        for args in ((r, c, v), _sorted(r, c, v),
                     (r[:0], c[:0], v[:0])):
            ji, jv = jpoisson.coo_like_to_padded(*args, 9)
            ti, tv = tpoisson.coo_like_to_padded(*args, 9)
            assert ti.dtype == ji.dtype and ti.shape == ji.shape
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tv, jv)

    def test_rows_not_divisible(self):
        with pytest.raises(ValueError, match="divisible"):
            tpoisson.block_split_ell(*_poisson(5, 3), nblocks=2,
                                     dtype=torch.float64, device=CPU)

    def test_block_poisson2d_ell(self):
        j = jbo.block_poisson2d_ell(8, 6, dtype=jnp.float64)
        t = tbo.block_poisson2d_ell(8, 6, dtype=torch.float64, device=CPU)
        for a, b in ((j.a_ii, t.a_ii), (j.a_ic, t.a_ic)):
            np.testing.assert_array_equal(b.indices.numpy(),
                                          np.asarray(a.indices))
            np.testing.assert_array_equal(b.values.numpy(),
                                          np.asarray(a.values))


def _sorted(r, c, v):
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


# ---------------------------------------------------------------------------
# The hooks of the three stacked operators
# ---------------------------------------------------------------------------

def _ops(route):
    """(JAX op, port op, dense matrix) for a route: the unrouted ELL, the
    DIA planes of a banded split, the BSR of a blockable one (sub-block 8,
    Jacobi blocks a multiple of it) and a BSR whose Jacobi blocks are not
    a multiple of its sub-block (24 rows, c = 16: each block padded)."""
    if route == "ell":
        coo = _block_ill(nbk=8)
        jop, top = _ell_pair(coo)
    elif route == "dia":
        coo = _variable_coeff()
        je, te = _ell_pair(coo)
        jop, top = jbo.from_stacked_ell(je), tbo.from_stacked_ell(te)
    elif route == "bsr":
        coo = _blocky()
        je, te = _ell_pair(coo)
        jop = jbo.stacked_bsr_from_ell(je, (8,), 64.0)
        top = tbo.stacked_bsr_from_ell(te, (8,), 64.0)
    else:
        coo = _coo(_random_block_sparse(6, 8, 2, seed=7, spd=True))
        je, te = _ell_pair(coo)
        jop = jbo.stacked_bsr_from_ell(je, (16,), 64.0)
        top = tbo.stacked_bsr_from_ell(te, (16,), 64.0)
    rows, cols, vals, shape = coo
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    return jop, top, dense


ROUTES = ["ell", "dia", "bsr", "bsr_padded"]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * max(np.abs(want).max(), 1.0))


def _probe_diag_dense(op, bidx, args_of):
    """Dense ``A_ii`` of block ``bidx`` from ``single_diag_mv`` on the
    identity's columns."""
    bs = op.block_size
    a = args_of(op.diag_mv_args, bidx)
    return np.stack([op.single_diag_mv(a, e).numpy()
                     for e in torch.eye(bs, dtype=op.dtype)], axis=1)


def _jargs(args, b):
    return jax.tree_util.tree_map(lambda t: t[b], args)


def _targs(args, b):
    return tuple(a[b] for a in args) if isinstance(args, tuple) else args[b]


class TestStackedHooks:
    @pytest.mark.parametrize("route", ROUTES)
    def test_products(self, route):
        jop, top, dense = _ops(route)
        assert type(top).__name__ == type(jop).__name__
        nb, bs = jop.nblocks, jop.block_size
        assert (top.nblocks, top.block_size, top.shape, top.nnz,
                top.dtype) == (nb, bs, jop.shape, jop.nnz, torch.float64)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((nb, bs))
        panel = rng.standard_normal((3, nb, bs))
        for hook in ("diag_mv", "coupling_mv", "full_mv"):
            tf, jf = getattr(top, hook), getattr(jop, hook)
            _close(tf(torch.from_numpy(x)).numpy(), jf(jnp.asarray(x)))
            _close(tf(torch.from_numpy(panel)).numpy(),
                   np.stack([jf(jnp.asarray(p)) for p in panel]))
        _close(top.global_mv(torch.from_numpy(x.reshape(-1))).numpy(),
               dense @ x.reshape(-1))
        _close(top.to_dense().numpy(), np.asarray(jop.to_dense()))
        _close(top.to_dense().numpy(), dense)

    @pytest.mark.parametrize("route", ROUTES)
    def test_per_block_hooks(self, route):
        jop, top, _ = _ops(route)
        rng = np.random.default_rng(2)
        nb, bs = jop.nblocks, jop.block_size
        ja, ta = jop.diag_mv_args, top.diag_mv_args
        for b in range(nb):
            xb = rng.standard_normal(bs)
            _close(top.single_diag_mv(_targs(ta, b),
                                      torch.from_numpy(xb)).numpy(),
                   jop.single_diag_mv(_jargs(ja, b), jnp.asarray(xb)))
            # a stack of vectors, as the batched inner solves pass them
            xs = rng.standard_normal((2, bs))
            _close(top.single_diag_mv(_targs(ta, b),
                                      torch.from_numpy(xs)).numpy(),
                   np.stack([jop.single_diag_mv(_jargs(ja, b),
                                                jnp.asarray(v)) for v in xs]))
            _close(top.single_diag_vector(_targs(ta, b), bs).numpy(),
                   jop.single_diag_vector(_jargs(ja, b), bs))

    @pytest.mark.parametrize("route", ROUTES)
    def test_diag_coo(self, route):
        """``diag_coo_np`` gives JAX's triplets, and they rebuild the dense
        ``A_ii`` that probing ``single_diag_mv`` gives (JAX
        ``TestDiagCooExtraction``)."""
        jop, top, _ = _ops(route)
        bs = top.block_size
        for b, (jt, tt) in enumerate(zip(jop.diag_coo_np(),
                                         top.diag_coo_np())):
            for j, t in zip(jt, tt):
                np.testing.assert_array_equal(t, j)
            rebuilt = np.zeros((bs, bs))
            np.add.at(rebuilt, tt[:2], tt[2])
            np.testing.assert_allclose(
                rebuilt, _probe_diag_dense(top, b, _targs), atol=1e-12)

    def test_bsr_diag_is_one_launch_pack(self):
        """The block-diagonal pack of ``StackedBSROperator``: block ``b``'s
        block-column ids moved by ``b * nbr``, the values a view."""
        _, top, _ = _ops("bsr_padded")
        nb, nbr, w = top.ii_idx.shape
        assert nbr * top.c > top.block_size
        assert top.merged_idx.shape == (nb * nbr, w)
        for b in range(nb):
            np.testing.assert_array_equal(
                top.merged_idx[b * nbr:(b + 1) * nbr].numpy(),
                top.ii_idx[b].numpy() + b * nbr)

    def test_other_dtypes_raise(self):
        rows, cols, vals, shape = _blocky()
        a, c = tpoisson.block_split_ell(rows, cols, vals, shape,
                                        dtype=torch.bfloat16, device=CPU)
        with pytest.raises(ValueError, match="float32"):
            tbo.StackedELLOperator(a_ii=a, a_ic=c)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

ROUTER_CASES = {
    # test_bsr.py TestLargeRouting.test_stacked_unbanded_warns
    "permuted_warns": (_permuted, {}),
    # test_bsr.py TestStackedBSR.test_routing_and_mv_match_ell
    "blocky_bsr": (_blocky, dict(max_diags=4, bsr_block_sizes=(8,),
                                 max_bsr_cost=64.0)),
    # test_multisplitting.py TestStackedDIA
    "variable_coeff_dia": (_variable_coeff, {}),
    "unstructured_stays_ell": (_variable_coeff,
                               dict(max_diags=2, max_bsr_cost=0.5)),
    "unbanded_blockable_bsr": (_unbanded_blockable, {}),
    "banded_past_dia_warns": (_variable_coeff, dict(max_diags=2)),
    # test_inner_bjacobi.py
    "block_ill_bsr": (_block_ill, {}),
    "poisson_dia": (_poisson, {}),
}


@pytest.mark.usefixtures("jax_table")
class TestRouter:
    @pytest.mark.parametrize("case", sorted(ROUTER_CASES))
    def test_same_route(self, case):
        make, kw = ROUTER_CASES[case]
        jell, tell = _ell_pair(make())
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jout = jbo.as_stacked_tpu_operator(jell, **kw)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            tout = tbo.as_stacked_routed_operator(tell, **kw)
        assert type(tout).__name__ == type(jout).__name__
        assert [w.category for w in tw] == [w.category for w in jw]
        if isinstance(tout, tbo.StackedELLOperator):
            assert jout is jell and tout is tell
            assert [w.category for w in tw] == [UserWarning]
        elif isinstance(tout, tbo.StackedBSROperator):
            assert tout.c == jout.ii_val.shape[-1]
            assert tuple(tout.ii_idx.shape) == jout.ii_idx.shape
            assert tout.ic.bs == jout.ic.bs
            np.testing.assert_array_equal(tout.ii_idx.numpy(),
                                          np.asarray(jout.ii_idx))
            np.testing.assert_array_equal(tout.ic.indices.numpy(),
                                          np.asarray(jout.ic.indices))
        else:
            assert tout.dia_ii.offsets == jout.dia_ii.offsets
            assert tout.dia_ic.offsets == jout.dia_ic.offsets
        x = np.random.default_rng(4).standard_normal(
            (tout.nblocks, tout.block_size))
        _close(tout.full_mv(torch.from_numpy(x)).numpy(),
               jout.full_mv(jnp.asarray(x)))

    def test_other_operators_pass_through(self):
        op = tbo.block_poisson2d(8, 8)
        assert tbo.as_stacked_routed_operator(op) is op

    def test_from_stacked_ell_max_diags(self):
        """Past ``max_diags`` the input comes back as it is."""
        _, tell = _ell_pair(_variable_coeff())
        assert tbo.from_stacked_ell(tell, max_diags=2) is tell
        assert isinstance(tbo.from_stacked_ell(tell, max_diags=5),
                          tbo.StackedDIAOperator)

    def test_no_blockable_size(self):
        _, tell = _ell_pair(_permuted())
        assert tbo.stacked_bsr_from_ell(tell, (8,), 0.5) is None


# ---------------------------------------------------------------------------
# Conversion from the JAX package
# ---------------------------------------------------------------------------

class TestConvert:
    @pytest.mark.parametrize("route", ["ell", "dia", "bsr", "bsr_padded"])
    def test_stacked(self, route):
        jop, _, _ = _ops(route)
        top = convert.from_jax_operator(jop, CPU)
        assert type(top).__name__ == type(jop).__name__
        x = np.random.default_rng(5).standard_normal(
            (jop.nblocks, jop.block_size))
        for hook in ("diag_mv", "coupling_mv"):
            _close(getattr(top, hook)(torch.from_numpy(x)).numpy(),
                   getattr(jop, hook)(jnp.asarray(x)))
        if route.startswith("bsr"):
            # the coupling of a symmetric matrix shares its transpose pack
            assert jop.ic.values_t is jop.ic.values
            assert top.ic.values_t is top.ic.values

    @pytest.mark.parametrize("dims", [(2, 4, 5), (3, 4, 3, 5)])
    def test_strips(self, dims):
        jop = (jops.StencilStrip2D(*dims[1:]) if len(dims) == 3
               else jops.StencilStrip3D(*dims[1:]))
        top = convert.from_jax_operator(jop, CPU)
        assert type(top).__name__ == type(jop).__name__
        assert (top.shape, top.nnz, top.diag, top.off) == (
            jop.shape, jop.nnz, jop.diag, jop.off)


# ---------------------------------------------------------------------------
# The strip operators
# ---------------------------------------------------------------------------

class TestStrips:
    @pytest.mark.parametrize("grid", [(8, 6), (6, 4, 5)])
    def test_against_jax(self, grid):
        if len(grid) == 2:
            jop, top = jpoisson.strip2d(*grid), tpoisson.strip2d(*grid)
            halo = grid[1]
        else:
            jop, top = jpoisson.strip3d(*grid), tpoisson.strip3d(*grid)
            halo = grid[1] * grid[2]
        assert (top.shape, top.nnz) == (jop.shape, jop.nnz)
        rng = np.random.default_rng(6)
        x = rng.standard_normal(top.shape[0])
        top_h, bot_h = rng.standard_normal(halo), rng.standard_normal(halo)
        T = torch.from_numpy
        _close(top.mv(T(x)).numpy(), jop.mv(jnp.asarray(x)))
        _close(top.rmv(T(x)).numpy(), jop.rmv(jnp.asarray(x)))
        _close(top.coupling(T(top_h), T(bot_h)).numpy(),
               jop.coupling(jnp.asarray(top_h), jnp.asarray(bot_h)))
        _close(top.mv_full(T(x), T(top_h), T(bot_h)).numpy(),
               jop.mv_full(jnp.asarray(x), jnp.asarray(top_h),
                           jnp.asarray(bot_h)))

    def test_strip_row_of_stacked(self):
        """``mv_full`` of strip ``k`` with its neighbours' boundary rows is
        row strip ``k`` of the stacked operator's ``full_mv``."""
        st = tbo.block_poisson2d(12, 5, nblocks=3)
        strip = tpoisson.strip2d(12, 5, nblocks=3)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (3, st.block_size)))
        full = st.full_mv(x)
        top, bottom = st.halos(x)
        for k in range(3):
            torch.testing.assert_close(
                strip.mv_full(x[k], top[k], bottom[k]), full[k],
                rtol=1e-12, atol=1e-12)

    def test_not_divisible(self):
        for make, args in ((tpoisson.strip2d, (5, 4)),
                           (tpoisson.strip3d, (5, 4, 4))):
            with pytest.raises(ValueError, match="not divisible"):
                make(*args, nblocks=2)
