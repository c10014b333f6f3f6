"""Port parity for the slice as a whole: the two-stage multisplitting
drivers (``models/multisplitting.py``) on the stacked Poisson strips.

Each case runs the JAX ``multisplit_solve`` (through its named entry
points) and the port on the same right-hand side, in f64 on the CPU, and
holds the port to the JAX run: the sweep and cycle counts and the async
``certified`` flag exactly, and the golden counts of
``tests/test_golden.py`` (2D 32^2, default ``InnerConfig``, rtol 1e-3) on
both.

The iterates are held at two depths.  After the first cycle the two
agree to 1e-12 relative to the largest entry: one sweep of the port is
the JAX sweep, up to the order in which sums are taken.  At convergence
a GMRES-inner run cannot agree that closely with any other
implementation, because the sweep map amplifies a one-ulp difference by
about 1e9 over a solve: the JAX run against itself, with ``b`` changed
by 1e-16 relative, moves x by 5e-7 (SM) and 6e-7 (AM) at 32^2.  There
the iterates are held to 1e-4 (the largest difference measured is
2e-5), and the inner iteration totals, which count a borderline inner
test one way or the other, to 1%.  A Chebyshev inner solve is linear in
its inputs and keeps 1e-12 to the end.  The inner methods ``cg``,
``bicgstab`` and ``ca_gmres`` sit in between: unpreconditioned they are
held like GMRES (1e-4, totals to 1%); under ``pc='mg'`` every inner solve
takes a handful of iterations to well below its rtol, nothing is
borderline, and the iterates and totals agree to 1e-10 and exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.models import multisplitting as jms
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops as tbo
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import multisplitting as tms

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)


def _ops(shape, nblocks=2):
    if len(shape) == 2:
        return (jbo.block_poisson2d(*shape, nblocks),
                tbo.block_poisson2d(*shape, nblocks))
    return (jbo.block_poisson3d(*shape, nblocks),
            tbo.block_poisson3d(*shape, nblocks))


def _run(shape, entry, jkw, tkw=None, nblocks=2):
    """Run ``entry`` (``sm``, ``am``, ``smsm``, ``amam``) in both
    packages on ``b = A 1``; ``tkw`` defaults to ``jkw`` with the
    configs carried across."""
    jop, top = _ops(shape, nblocks)
    b = np.asarray(jbo.rhs_ones(jop, jnp.float64))
    rj = getattr(jms, entry)(jop, jnp.asarray(b), **jkw)
    rt = getattr(tms, entry)(top, torch.from_numpy(b),
                             **(_port_kw(jkw) if tkw is None else tkw))
    return rj, rt


def _port_cfg(c):
    if isinstance(c, (list, tuple)):
        return type(c)(_port_cfg(x) for x in c)
    cls = tms.InnerConfig if isinstance(c, jms.InnerConfig) else tms.OuterConfig
    return cls(**{f: getattr(c, f) for f in cls.__dataclass_fields__})


def _port_kw(jkw):
    return {k: (_port_cfg(v) if k in ("inner", "outer") else v)
            for k, v in jkw.items()}


def _assert_same(rj, rt, x_rtol, iters_exact=True):
    t = convert.multisplit_result_to_numpy(rt)
    assert t["sweeps"] == int(rj.sweeps)
    assert t["cycles"] == int(rj.cycles)
    if iters_exact:
        assert int(t["inner_iters"]) == int(rj.inner_iters)
    else:
        assert abs(int(t["inner_iters"]) - int(rj.inner_iters)) <= \
            0.01 * int(rj.inner_iters)
    assert t["converged"] == bool(rj.converged)
    if rj.certified is None:
        assert t["certified"] is None and t["tail_sweeps"] is None
    else:
        assert t["certified"] == bool(rj.certified)
        assert t["tail_sweeps"] == int(rj.tail_sweeps)
    xj = np.asarray(rj.x)
    assert t["x"].shape == xj.shape and t["x"].dtype == np.float64
    assert np.abs(t["x"] - xj).max() <= x_rtol * np.abs(xj).max()
    np.testing.assert_allclose(t["rnorm0"], float(rj.rnorm0), rtol=1e-12)
    if x_rtol <= 1e-12:
        for f in ("rnorm", "local_rnorms", "outer_rnorm"):
            ref = np.asarray(getattr(rj, f))
            if np.all(np.isfinite(ref)):
                np.testing.assert_allclose(t[f], ref, rtol=1e-8, err_msg=f)
    return t


GOLDEN = [
    ("sm", "sm", {"maxiter": 2000}, 42),
    ("am_stale2", "am", {"staleness": 2, "maxiter": 4000}, 88),
    ("smsm_local", "smsm", {"scope": "local", "s": 4, "maxiter": 2000}, 36),
    ("smsm_semi_local", "smsm", {"scope": "semi_local", "s": 4,
                                 "maxiter": 2000}, 12),
    ("smsm_global", "smsm", {"scope": "global", "s": 4, "maxiter": 2000}, 12),
]


class TestGolden:
    @pytest.mark.parametrize("name,entry,kw,sweeps", GOLDEN,
                             ids=[g[0] for g in GOLDEN])
    def test_counts_and_iterates(self, name, entry, kw, sweeps):
        rj, rt = _run((32, 32), entry, dict(kw, rtol=1e-3))
        assert int(rj.sweeps) == sweeps
        t = _assert_same(rj, rt, 1e-4)
        assert t["converged"]
        # host reads: the entry test, one per outer cycle and, for an async
        # run, one per certification round; GMRES(maxiter 20) takes one
        # restart cycle a sweep and reads nothing
        tail = 0 if rj.certified is None else 1 + t["tail_sweeps"]
        assert t["syncs"] == 1 + t["cycles"] + tail

    @pytest.mark.parametrize("name,entry,kw,sweeps", GOLDEN,
                             ids=[g[0] for g in GOLDEN])
    def test_first_cycle(self, name, entry, kw, sweeps):
        """One cycle (three sweeps without minimization): the same
        iterate to 1e-12."""
        kw = dict(kw, rtol=1e-3, maxiter=kw.get("s", 3))
        rj, rt = _run((32, 32), entry, kw)
        _assert_same(rj, rt, 1e-12)


class TestThesisConfigs:
    def test_chebyshev_inner_global_3d(self):
        """The JAX bench's flagship at 8^3: SMSM_GLOBAL with
        Chebyshev(20) inner solves on the analytic strip bounds."""
        kw = dict(scope="global", s=4, rtol=1e-5, maxiter=2000,
                  inner=jms.InnerConfig(method="chebyshev", maxiter=20))
        rj, rt = _run((8, 8, 8), "smsm", kw)
        t = _assert_same(rj, rt, 1e-12)
        assert t["converged"]

    def test_lsqr_outer_global_s20(self):
        """The reference's active Grid'5000 configuration on the stacked
        strips: s=20, rtol 1e-4, inner gmres(20), outer lsqr(70)."""
        kw = dict(scope="global", s=20, rtol=1e-4, maxiter=2000,
                  inner=jms.InnerConfig(maxiter=20),
                  outer=jms.OuterConfig(method="lsqr", maxiter=70))
        rj, rt = _run((32, 32), "smsm", kw)
        t = _assert_same(rj, rt, 1e-4)
        assert t["converged"] and t["cycles"] == 1 and t["sweeps"] == 20


OPTIONS = {
    "amam_local_publish": ("amam", dict(
        scope="local", s=3, staleness=(1, 2), basis_collection="publish",
        min_convergence_count=2)),
    "amam_global": ("amam", dict(scope="global", s=3, staleness=2,
                                 min_convergence_count=2)),
    "per_block_inner": ("sm", dict(inner=(
        jms.InnerConfig(maxiter=10, rtol=1e-2),
        jms.InnerConfig(maxiter=25, restart=12, orthog="cgs")))),
    "per_block_outer_alpha_average": ("smsm", dict(
        scope="semi_local", s=3,
        outer=(jms.OuterConfig(method="normal", alpha_average=True),
               jms.OuterConfig(method="qr", alpha_average=True)))),
    "jacobi_pc": ("smsm", dict(scope="local", s=3,
                               inner=jms.InnerConfig(pc="jacobi"))),
    "outer_cgne_bf16_basis": ("smsm", dict(
        scope="global", s=3, outer=jms.OuterConfig(method="cgne"),
        inner=jms.InnerConfig(basis="bf16"))),
    "history_and_rnorm0": ("sm", dict(record_history=True, rnorm0=50.0)),
    "four_blocks_chebyshev": ("smsm", dict(
        scope="semi_local", s=2,
        inner=jms.InnerConfig(method="chebyshev", maxiter=8))),
}


class TestOptions:
    @pytest.mark.parametrize("case", list(OPTIONS))
    def test_against_jax(self, case):
        entry, kw = OPTIONS[case]
        nb = 4 if case.startswith("four_blocks") else 2
        rj, rt = _run((16, 16), entry, dict(kw, rtol=1e-4, maxiter=1500),
                      nblocks=nb)
        cheb = case.endswith("chebyshev")
        t = _assert_same(rj, rt, 1e-12 if cheb else 1e-4, iters_exact=cheb)
        assert t["converged"]
        if kw.get("record_history"):
            hj = np.asarray(rj.history)
            assert t["history"].shape == hj.shape
            reached = np.isfinite(hj)
            np.testing.assert_array_equal(np.isfinite(t["history"]), reached)
            # the first cycles' norms, before the amplification shows
            np.testing.assert_allclose(t["history"][:5], hj[:5], rtol=1e-10)


INNER = {
    "cg": ((16, 16), "sm", dict(inner=jms.InnerConfig(method="cg")), False),
    "bicgstab": ((16, 16), "sm",
                 dict(inner=jms.InnerConfig(method="bicgstab")), False),
    "ca_gmres": ((16, 16), "sm", dict(
        inner=jms.InnerConfig(method="ca_gmres", restart=6)), False),
    "ca_gmres_given_bounds": ((16, 16), "smsm", dict(
        scope="local", s=3, inner=jms.InnerConfig(
            method="ca_gmres", restart=4, eig_min=0.05, eig_max=7.9)), False),
    "cg_mg_global": ((16, 16), "smsm", dict(
        scope="global", s=3, inner=jms.InnerConfig(method="cg", pc="mg")),
        True),
    "gmres_mg": ((16, 16), "sm", dict(inner=jms.InnerConfig(pc="mg")), True),
    "bicgstab_mg": ((16, 16), "sm", dict(
        inner=jms.InnerConfig(method="bicgstab", pc="mg")), True),
    "gmres_mg_3d": ((8, 8, 8), "sm", dict(inner=jms.InnerConfig(pc="mg")),
                    True),
    "cg_mg_3d_async": ((16, 8, 8), "am", dict(
        staleness=2, inner=jms.InnerConfig(method="cg", pc="mg")), True),
    "per_block_cg_mg_and_ca_gmres": ((16, 16), "sm", dict(inner=(
        jms.InnerConfig(method="cg", pc="mg"),
        jms.InnerConfig(method="ca_gmres", restart=5))), False),
}


class TestInnerSolves:
    @pytest.mark.parametrize("case", list(INNER))
    def test_against_jax(self, case):
        """The inner methods and ``pc='mg'`` as the JAX package composes
        them: sweep and cycle counts equal, iterates and inner totals as
        the module's note says."""
        shape, entry, kw, tight = INNER[case]
        rj, rt = _run(shape, entry, dict(kw, rtol=1e-4, maxiter=1500))
        t = _assert_same(rj, rt, 1e-10 if tight else 1e-4, iters_exact=tight)
        assert t["converged"]

    def test_mg_cuts_the_inner_work(self):
        """What the preconditioner is for: the same sweeps with a small
        fraction of the inner iterations."""
        op = tbo.block_poisson2d(32, 32)
        b = tbo.rhs_ones(op, torch.float64, "cpu")
        plain = tms.sm(op, b, inner=tms.InnerConfig(method="cg"))
        mg = tms.sm(op, b, inner=tms.InnerConfig(method="cg", pc="mg"))
        assert plain.converged and mg.converged
        assert abs(mg.sweeps - plain.sweeps) <= 2
        assert int(mg.inner_iters) * 4 < int(plain.inner_iters)

    def test_lanczos_bounds_for_an_operator_without_analytic_ones(self):
        """A block operator that carries per-block arrays and no
        ``diag_eig_bounds``: Chebyshev and CA-GMRES inner solves estimate
        the interval by Lanczos over the blocks."""
        rng = np.random.default_rng(3)
        nb, bs = 2, 12
        q = np.linalg.qr(rng.standard_normal((nb, bs, bs)))[0]
        a = (q * np.linspace(1.0, 9.0, bs)) @ q.transpose(0, 2, 1)
        a = torch.from_numpy(0.5 * (a + a.transpose(0, 2, 1)))

        class DenseBlocks(tbo.BlockOperator):
            nblocks, block_size, diag, off = nb, bs, 1.0, 0.0
            dtype = torch.float64
            diag_mv_args = a

            def single_diag_mv(self, args, xb):
                return xb @ args.T

            def diag_mv(self, x):
                return torch.einsum("bij,...bj->...bi", a, x)

            def coupling_mv(self, x):
                return torch.zeros_like(x)

        op = DenseBlocks()
        lo, hi = tms._lanczos_block_bounds(op, "chebyshev")
        assert 0.85 <= lo <= 1.0 and 9.0 <= hi <= 10.0
        b = torch.from_numpy(rng.standard_normal((nb, bs)))
        for cfg in (tms.InnerConfig(method="chebyshev", maxiter=40),
                    tms.InnerConfig(method="ca_gmres", restart=4, maxiter=40,
                                    rtol=1e-8)):
            r = tms.sm(op, b, inner=cfg, rtol=1e-6, maxiter=50)
            assert r.converged
            torch.testing.assert_close(op.diag_mv(r.x), b, rtol=1e-5, atol=1e-6)
        op.diag_mv_args = None
        with pytest.raises(ValueError, match="Lanczos"):
            tms._lanczos_block_bounds(op, "chebyshev")


class TestRejects:
    @pytest.mark.parametrize("method,pc", [
        ("cg", "none"), ("bicgstab", "none"), ("ca_gmres", "none"),
        ("gmres", "bjacobi"), ("gmres", "mg")])
    def test_not_ported(self, method, pc):
        """The inner options that once waited for their port run on the
        stencil strips, but ``pc='bjacobi'``, which belongs to the stacked
        sparse operators: on a stencil stack it raises JAX's
        ``ValueError``."""
        op = tbo.block_poisson2d(8, 8)
        b = tbo.rhs_ones(op, torch.float64, "cpu")
        cfg = tms.InnerConfig(method=method, pc=pc, restart=4)
        if pc == "bjacobi":
            with pytest.raises(ValueError, match="pc='mg'"):
                tms.sm(op, b, inner=cfg)
        else:
            assert tms.sm(op, b, inner=cfg).converged

    @pytest.mark.parametrize("case", [
        "chebyshev_with_pc", "ca_gmres_with_pc", "unknown_pc",
        "mg_without_stencil_blocks"])
    def test_inner_composition_errors(self, case):
        """The errors of the JAX ``_make_single_inner``, in both
        packages."""
        jop, top = _ops((8, 8))
        b = tbo.rhs_ones(top, torch.float64, "cpu")
        kw = {
            "chebyshev_with_pc": dict(method="chebyshev", pc="jacobi"),
            "ca_gmres_with_pc": dict(method="ca_gmres", pc="mg"),
            "unknown_pc": dict(pc="ilu"),
            "mg_without_stencil_blocks": dict(pc="mg"),
        }[case]
        if case == "mg_without_stencil_blocks":
            class Bare(tbo.BlockOperator):
                nblocks, block_size, diag = 2, 32, 4.0

            with pytest.raises(ValueError, match="stencil-family"):
                tms._make_single_inner(Bare(), tms.InnerConfig(**kw))
            return
        with pytest.raises(ValueError) as et:
            tms.sm(top, b, inner=tms.InnerConfig(**kw))
        with pytest.raises(ValueError) as ej:
            jms.sm(jop, jnp.asarray(b.numpy()), inner=jms.InnerConfig(**kw))
        assert str(et.value) == str(ej.value)

    @pytest.mark.parametrize("case", [
        "schedule", "scope", "sync_staleness", "b_shape", "collection",
        "inner_method", "outer_method", "per_block_global", "basis"])
    def test_bad_arguments(self, case):
        op = tbo.block_poisson2d(8, 8)
        b = tbo.rhs_ones(op, torch.float64, "cpu")
        calls = {
            "schedule": lambda: tms.multisplit_solve(op, b, schedule="chaotic"),
            "scope": lambda: tms.smsm(op, b, scope="everywhere"),
            "sync_staleness": lambda: tms.multisplit_solve(op, b, staleness=2),
            "b_shape": lambda: tms.sm(op, b.reshape(-1)),
            "collection": lambda: tms.amam(op, b, basis_collection="never"),
            "inner_method": lambda: tms.sm(
                op, b, inner=tms.InnerConfig(method="jacobi")),
            "outer_method": lambda: tms.smsm(
                op, b, outer=tms.OuterConfig(method="svd")),
            "per_block_global": lambda: tms.smsm(
                op, b, outer=(tms.OuterConfig(), tms.OuterConfig(damping=1.0))),
            "basis": lambda: tms.sm(op, b, inner=tms.InnerConfig(basis="fp8")),
        }
        with pytest.raises(ValueError):
            calls[case]()


class TestConvertAndExports:
    def test_state_round_trip(self):
        jop, top = _ops((16, 16))
        assert convert.from_jax_operator(jop) == top
        b = np.asarray(jbo.rhs_ones(jop, jnp.float64))
        rj = jms.sm(jop, jnp.asarray(b), rtol=1e-2, maxiter=50)
        fields = {f: (None if getattr(rj, f) is None
                      else np.asarray(getattr(rj, f)))
                  for f in ("x", "sweeps", "cycles", "inner_iters", "rnorm",
                            "rnorm0", "local_rnorms", "outer_rnorm",
                            "converged", "history", "certified", "tail_sweeps")}
        r = convert.multisplit_result_from_numpy(fields, "cpu")
        assert isinstance(r.x, torch.Tensor) and r.sweeps == int(rj.sweeps)
        assert r.converged is bool(rj.converged) and r.history is None
        back = convert.multisplit_result_to_numpy(r)
        np.testing.assert_array_equal(back["x"], fields["x"])
        # the port, started from JAX's result, is already converged
        rt = tms.multisplit_solve(top, torch.from_numpy(b), r.x, rtol=1e-2,
                                  maxiter=50, rnorm0=float(rj.rnorm0))
        assert rt.sweeps <= 1
