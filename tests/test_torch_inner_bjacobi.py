"""Port parity for the inner preconditioners of the multisplitting drivers
on general sparse matrices: ``pc='bjacobi'`` (each ``A_ii``'s diagonal
sub-blocks inverted, ``_bjacobi_inner_inv``) and ``pc='jacobi'`` with
each block's own diagonal, through the stacked ELL, DIA and BSR operators
(the twin of ``tests/test_inner_bjacobi.py`` and of the stacked cases of
``tests/test_multisplitting.py`` and ``tests/test_bsr.py``).

Both packages solve from the same numpy matrix, in f64 on the CPU.  The
sweep, cycle and inner-iteration counts must be equal (the inner totals
of one case with borderline inner tests to 1%); the iterates are
held to 1e-4 of the largest entry, as the GMRES-inner parity of
``tests/test_torch_multisplitting.py`` holds them (a GMRES-inner sweep
map amplifies a one-ulp difference about 1e9 over a solve).  The golden
pins of the stencil path (2D 32^2: SM 42, SMSM_GLOBAL 12) hold through the
DIA route and through the unrouted ELL in both packages, and SM with
``pc='bjacobi'`` (blocks of 64) takes 41 sweeps.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.models import multisplitting as jms
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson as tpoisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops as tbo
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import multisplitting as tms

from test_torch_routing import jax_table  # noqa: F401  (fixture)

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)


def _block_ill_matrix(nbk=16, bsk=16, seed=31, coupling=1e-2):
    rng = np.random.default_rng(seed)
    n = nbk * bsk
    A = sp.lil_matrix((n, n))
    for k in range(nbk):
        Q, _ = np.linalg.qr(rng.standard_normal((bsk, bsk)))
        lam = np.logspace(0, 3, bsk)
        A[k * bsk:(k + 1) * bsk, k * bsk:(k + 1) * bsk] = (Q * lam) @ Q.T
    C = sp.random(n, n, density=0.02, random_state=seed + 1)
    return (A.tocsr() + coupling * (C + C.T)).tocsr()


def _stacked(coo, route=True, **route_kw):
    """(JAX op, port op): the block split into 2 stacked ELL operators,
    routed by each package's router when ``route``."""
    rows, cols, vals, shape = coo
    ja, jc = jpoisson.block_split_ell(rows, cols, vals, shape, nblocks=2,
                                      dtype=jnp.float64)
    ta, tc = tpoisson.block_split_ell(rows, cols, vals, shape, nblocks=2,
                                      dtype=torch.float64, device="cpu")
    jop = jbo.StackedELLOperator(a_ii=ja, a_ic=jc)
    top = tbo.StackedELLOperator(a_ii=ta, a_ic=tc)
    if route:
        jop = jbo.as_stacked_tpu_operator(jop, **route_kw)
        top = tbo.as_stacked_routed_operator(top, **route_kw)
    assert type(top).__name__ == type(jop).__name__
    return jop, top


def _coo(A):
    c = A.tocoo()
    return c.row, c.col, c.data, c.shape


def _cfg(cls, c):
    if isinstance(c, (list, tuple)):
        return type(c)(_cfg(cls, x) for x in c)
    return cls(**c)


def _run(jop, top, entry, b, inner=None, **kw):
    """``entry`` in both packages on the stacked ``b``; ``inner`` is a
    mapping of ``InnerConfig`` fields, or a tuple of them."""
    jkw, tkw = dict(kw), dict(kw)
    if inner is not None:
        jkw["inner"] = _cfg(jms.InnerConfig, inner)
        tkw["inner"] = _cfg(tms.InnerConfig, inner)
    rj = getattr(jms, entry)(jop, jnp.asarray(b), **jkw)
    rt = getattr(tms, entry)(top, torch.from_numpy(np.array(b)), **tkw)
    return rj, rt


def _assert_same(rj, rt, x_rtol=1e-4, iters_exact=True):
    t = convert.multisplit_result_to_numpy(rt)
    assert (t["sweeps"], t["cycles"]) == (int(rj.sweeps), int(rj.cycles))
    if iters_exact:
        assert int(t["inner_iters"]) == int(rj.inner_iters)
    else:
        assert abs(int(t["inner_iters"]) - int(rj.inner_iters)) <= \
            0.01 * int(rj.inner_iters)
    assert t["converged"] == bool(rj.converged)
    xj = np.asarray(rj.x)
    assert np.abs(t["x"] - xj).max() <= x_rtol * np.abs(xj).max()
    return t


def _true_rel(A, x):
    b = A @ np.ones(A.shape[0])
    return np.linalg.norm(b - A @ x.reshape(-1)) / np.linalg.norm(b)


def _b_of(A):
    n = A.shape[0]
    return np.asarray(A @ np.ones(n)).reshape(2, n // 2)


@pytest.mark.usefixtures("jax_table")
class TestInnerBjacobi:
    def test_sm_bjacobi(self):
        A = _block_ill_matrix()
        jop, top = _stacked(_coo(A))
        assert isinstance(top, tbo.StackedBSROperator)
        b = _b_of(A)
        bj = dict(maxiter=10, rtol=1e-10, pc="bjacobi", pc_block_size=16)
        rj, rt = _run(jop, top, "sm", b, bj, rtol=1e-8, maxiter=3000)
        t = _assert_same(rj, rt)
        assert t["converged"] and _true_rel(A, t["x"]) <= 1.05e-8
        # the block inverses absorb the cond-1e3 sub-blocks
        none = tms.sm(top, torch.from_numpy(b), rtol=1e-8, maxiter=3000,
                      inner=tms.InnerConfig(maxiter=10, rtol=1e-10))
        assert int(t["inner_iters"]) < int(none.inner_iters) / 4

    def test_per_block_mixed_pc(self):
        A = _block_ill_matrix(seed=41)
        jop, top = _stacked(_coo(A))
        mixed = (dict(maxiter=20, rtol=1e-10),
                 dict(maxiter=20, rtol=1e-10, pc="bjacobi", pc_block_size=16))
        rj, rt = _run(jop, top, "sm", _b_of(A), mixed, rtol=1e-8,
                      maxiter=3000)
        t = _assert_same(rj, rt)
        assert t["converged"] and _true_rel(A, t["x"]) <= 1.05e-8

    def test_cg_true_residual_precond(self):
        A = _block_ill_matrix(seed=43)
        jop, top = _stacked(_coo(A))
        cfg = dict(maxiter=15, rtol=1e-10, method="cg", pc="bjacobi",
                   pc_block_size=16)
        rj, rt = _run(jop, top, "sm", _b_of(A), cfg, rtol=1e-8, maxiter=3000)
        t = _assert_same(rj, rt)
        assert t["converged"] and _true_rel(A, t["x"]) <= 1.05e-8

    def test_stencil_operator_rejects_bjacobi(self):
        op = tbo.block_poisson2d(16, 16, 2)
        b = tbo.rhs_ones(op, torch.float64, "cpu")
        with pytest.raises(ValueError, match="pc='mg'"):
            tms.sm(op, b, rtol=1e-3, maxiter=100,
                   inner=tms.InnerConfig(pc="bjacobi"))

    def test_bjacobi_inverses_per_block(self):
        """``_bjacobi_inner_inv``: JAX's stack of inverses, the one
        block's alone with ``only_block``, and the same tensor again."""
        A = _block_ill_matrix(nbk=8)
        jop, top = _stacked(_coo(A))
        jinv = np.asarray(jms._bjacobi_inner_inv(
            jop, jms.InnerConfig(pc="bjacobi", pc_block_size=16)))
        cfg = tms.InnerConfig(pc="bjacobi", pc_block_size=16)
        tinv = tms._bjacobi_inner_inv(top, cfg)
        assert tuple(tinv.shape) == jinv.shape == (2, 4, 16, 16)
        np.testing.assert_allclose(tinv.numpy(), jinv, rtol=1e-12,
                                   atol=1e-15)
        one = tms._bjacobi_inner_inv(top, cfg, only_block=1)
        torch.testing.assert_close(one, tinv[1:], rtol=0, atol=0)
        # factored once per sub-block size, then kept on the operator
        assert tms._bjacobi_inner_inv(top, cfg) is tinv
        assert tms._bjacobi_inner_inv(top, tms.InnerConfig()) is None


@pytest.mark.usefixtures("jax_table")
class TestInnerJacobi:
    def test_per_block_diagonal_ell(self):
        """ELL with a diagonal that differs between the blocks (JAX
        ``test_jacobi_pc_ell_variable_diag``): each block's own."""
        rows, cols, vals, shape = jpoisson.poisson2d_coo(16, 16)
        scale = 1.0 + (np.arange(shape[0]) % 7) * 0.3
        coo = (rows, cols, vals * scale[rows], shape)
        jop, top = _stacked(coo, route=False)
        b = np.asarray(jbo.rhs_ones(jop, jnp.float64))
        rj, rt = _run(jop, top, "sm", b, dict(pc="jacobi", maxiter=30),
                      rtol=1e-4, maxiter=4000)
        assert _assert_same(rj, rt)["converged"]
        # block 1's diagonal is not block 0's
        d = [top.single_diag_vector((top.a_ii.indices[i],
                                     top.a_ii.values[i]), top.block_size)
             for i in range(2)]
        assert not torch.equal(d[0], d[1])

    def test_per_block_configs_take_own_diagonal(self):
        """Per-block configs through ``StackedDIAOperator``: each block's
        solve scales by that block's diagonal.  Its inner totals count
        borderline inner tests (the port's move by 2 of 970 when ``b``
        moves by 1e-15 at 16^2), so they are held to 1%, as in
        ``tests/test_torch_multisplitting.py``."""
        rows, cols, vals, shape = jpoisson.poisson2d_coo(12, 12)
        scale = 1.0 + (np.arange(shape[0]) % 5) * 0.5
        coo = (rows, cols, vals * scale[rows], shape)
        jop, top = _stacked(coo)
        assert isinstance(top, tbo.StackedDIAOperator)
        b = np.asarray(jbo.rhs_ones(jop, jnp.float64))
        mixed = (dict(pc="jacobi", maxiter=30), dict(pc="jacobi", maxiter=20))
        rj, rt = _run(jop, top, "sm", b, mixed, rtol=1e-4, maxiter=4000)
        assert _assert_same(rj, rt, iters_exact=False)["converged"]

    def test_smsm_global_via_stacked_bsr(self):
        """SMSM_GLOBAL on a blockable system through ``StackedBSROperator``
        (JAX ``test_multisplitting_solve_via_stacked_bsr``)."""
        rng = np.random.default_rng(51)
        nb, bs = 8, 8
        A = sp.lil_matrix((nb * bs, nb * bs))
        for r in range(nb):
            for c in rng.choice(nb, size=2, replace=False):
                A[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = (
                    rng.standard_normal((bs, bs)))
        A = A.tocsr()
        A = ((A @ A.T).tocsr() + sp.eye(nb * bs) * nb * bs).tocsr()
        jop, top = _stacked(_coo(A), max_diags=4, bsr_block_sizes=(8,),
                            max_bsr_cost=64.0)
        assert isinstance(top, tbo.StackedBSROperator)
        cfg = dict(restart=20, maxiter=20, rtol=1e-10, pc="jacobi")
        rj, rt = _run(jop, top, "multisplit_solve", _b_of(A), cfg,
                      schedule="sync", minimization="global", s=4,
                      rtol=1e-8, maxiter=400)
        t = _assert_same(rj, rt)
        assert t["converged"] and _true_rel(A, t["x"]) <= 1e-8


GOLDEN = [("sm", "sm", {}, None, 42),
          ("smsm_global", "smsm", {"scope": "global", "s": 4}, None, 12),
          ("sm_bjacobi64", "sm", {},
           dict(pc="bjacobi", pc_block_size=64), 41)]


class TestGoldenThroughSparseRoutes:
    @pytest.mark.parametrize("route", [True, False], ids=["dia", "ell"])
    @pytest.mark.parametrize("name,entry,kw,inner,sweeps", GOLDEN,
                             ids=[g[0] for g in GOLDEN])
    def test_pins(self, route, name, entry, kw, inner, sweeps):
        """The 2D 32^2 Poisson matrix assembled, split and (for 'dia')
        routed: the stencil path's golden counts, in both packages."""
        jop, top = _stacked(jpoisson.poisson2d_coo(32, 32), route=route)
        assert isinstance(top, tbo.StackedDIAOperator if route
                          else tbo.StackedELLOperator)
        b = np.asarray(jbo.rhs_ones(jop, jnp.float64))
        rj, rt = _run(jop, top, entry, b, inner, rtol=1e-3, maxiter=2000,
                      **kw)
        assert int(rj.sweeps) == sweeps
        assert _assert_same(rj, rt)["converged"]
