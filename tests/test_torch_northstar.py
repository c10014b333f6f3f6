"""Port parity for the slice as a whole: the double-float-refined MG-PCG
north-star (``solvers/refine.py``), the state carried across from JAX
(``convert.py``), the package boundary, and ``chip_smoke.py``'s refusal
to run without a card."""

import ast
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as jpoisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64 as jdf
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import refine as jref
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import cg as jcg
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
    mg_preconditioner as jmgp,
)
import medane_tchakorom_ufc_thesis_repository_tpu_torch as port
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64 as tdf
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import refine as tref

# one intra-op thread a process: the suite runs in several worker
# processes at once, and a PyTorch thread pool in each of them would
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "medane_tchakorom_ufc_thesis_repository_tpu_torch"


def _host_check(x64, n):
    mv = jref.stencil3d_mv_np(n, n, n)
    b = mv(np.ones(n ** 3))
    rel = np.linalg.norm(b - mv(x64.reshape(-1))) / np.linalg.norm(b)
    return rel, np.abs(x64 - 1.0).max()


class TestNorthstar:
    def test_matches_jax_at_32(self):
        """The case of ``tests/test_refine.py:68-90`` in both packages:
        the same pass count, both to 1e-8 checked in f64 on the host."""
        n = 32
        rj = jref.df_northstar_fused(jpoisson.poisson3d(n, n, n), rtol=1e-8)
        # the same b = A·1 (small integers, exact in f32), from numpy
        b = jref.stencil3d_mv_np(n, n, n)(np.ones(n ** 3)).reshape(n, n, n)
        b_df = convert.df_pair_from_numpy(b.astype(np.float32),
                                          np.zeros_like(b, np.float32), "cpu")
        rt = port.df_northstar_fused(port.poisson3d(n, n, n), b_df, rtol=1e-8)
        assert rt.converged and rj.converged
        assert rt.passes == rj.passes <= 3
        assert len(rt.pcg_iters) == rt.passes
        assert rt.syncs == sum(rt.pcg_iters) + 2 * rt.passes + 2
        for x64 in (tdf.df_to_f64(rt.x), jdf.df_to_f64(rj.x)):
            rel, err = _host_check(x64, n)
            assert rel <= 1e-8 and err <= 1e-7
        # ||b|| is an f32 sum taken in another order by each package
        np.testing.assert_allclose(rt.rnorm0, rj.rnorm0, rtol=1e-5)

    def test_builds_b_on_device(self):
        r = port.df_northstar_fused(port.poisson3d(16, 16, 16), rtol=1e-8,
                                    device="cpu")
        rel, err = _host_check(tdf.df_to_f64(r.x), 16)
        assert r.converged and rel <= 1e-8 and err <= 1e-7

    def test_max_passes_stops(self):
        r = port.df_northstar_fused(port.poisson3d(16, 16, 16), rtol=1e-14,
                                    max_passes=1, device="cpu")
        assert r.passes == 1 and not r.converged

    def test_iterative_refinement_matches_jax(self):
        """The CLI's stacked MGPCG route: host-loop df refinement around
        an f32 MG-PCG solve, in both packages."""
        n = 16
        jop, top = jpoisson.poisson3d(n, n, n), port.poisson3d(n, n, n)
        b64 = jref.stencil3d_mv_np(n, n, n)(np.ones(n ** 3)).reshape(n, n, n)
        Mj, Mt = jmgp(jop), port.mg_preconditioner(top)
        solve_j = jax.jit(lambda r: jcg(jop.mv, r, maxiter=40, rtol=1e-5,
                                        precond=Mj).x)
        rj = jref.df_iterative_refinement(jop, b64, solve_j, rtol=1e-10)
        rt = tref.df_iterative_refinement(
            top, b64, lambda r: port.cg(top.mv, r, maxiter=40, rtol=1e-5,
                                        precond=Mt).x, rtol=1e-10,
            device="cpu")
        assert rt.converged and rj.converged
        assert rt.passes == rj.passes
        # the f32 solves round differently: the residuals agree in size
        np.testing.assert_allclose(np.log10(rt.rel_history),
                                   np.log10(rj.rel_history), atol=0.3)
        np.testing.assert_allclose(rt.x, 1.0, atol=1e-9)
        # the device-pair form of b, and the pair left on the device
        b_df = tdf.df_from_f64(b64, "cpu")
        rd = tref.df_iterative_refinement(
            top, None, lambda r: port.cg(top.mv, r, maxiter=40, rtol=1e-5,
                                         precond=Mt).x, rtol=1e-10,
            b_df=b_df, return_host=False)
        assert rd.passes == rt.passes and isinstance(rd.x, tuple)
        zero = tref.df_iterative_refinement(top, np.zeros((n, n, n)), None,
                                            device="cpu")
        assert zero.converged and zero.passes == 0

    def test_host_matvec_matches_jax(self):
        x = np.random.default_rng(0).standard_normal(5 * 6 * 7)
        np.testing.assert_array_equal(tref.stencil3d_mv_np(5, 6, 7)(x),
                                      jref.stencil3d_mv_np(5, 6, 7)(x))


class TestFusedProgram:
    """The twin of JAX's ``_df_fused_program`` (``solvers/refine.py``): one
    cached program for an operator and the nine static parameters, its
    steps run eagerly on the CPU (CUDA graphs on the card)."""

    PARAMS = (1e-8, 6, 1e-4, 40, 2, 4, 40, "w")

    def test_cached_per_operator_and_parameters(self):
        op = port.poisson3d(8, 8, 8)
        prog = tref._df_fused_program(op, *self.PARAMS)
        assert tref._df_fused_program(port.poisson3d(8, 8, 8),
                                      *self.PARAMS) is prog
        others = [(1e-9, 6, 1e-4, 40, 2, 4, 40, "w"),
                  (1e-8, 5, 1e-4, 40, 2, 4, 40, "w"),
                  (1e-8, 6, 1e-5, 40, 2, 4, 40, "w"),
                  (1e-8, 6, 1e-4, 30, 2, 4, 40, "w"),
                  (1e-8, 6, 1e-4, 40, 1, 4, 40, "w"),
                  (1e-8, 6, 1e-4, 40, 2, 2, 40, "w"),
                  (1e-8, 6, 1e-4, 40, 2, 4, 20, "w"),
                  (1e-8, 6, 1e-4, 40, 2, 4, 40, "v")]
        for params in others:
            assert tref._df_fused_program(op, *params) is not prog
        assert tref._df_fused_program(port.poisson3d(8, 8, 4),
                                      *self.PARAMS) is not prog
        assert tref._df_fused_program(port.poisson2d(8, 8),
                                      *self.PARAMS) is not prog

    @pytest.mark.parametrize("dims", [(16, 16, 16), (64, 64)])
    def test_program_is_the_eager_solve(self, dims):
        """The program's steps against ``df_iterative_refinement`` around
        ``cg``: the same PCG counts and x to the bit, twice in a row (the
        second call reuses the program's buffers)."""
        op = (port.poisson3d if len(dims) == 3 else port.poisson2d)(*dims)
        bhi = op.mv(torch.ones(dims))
        b_df = (bhi, torch.zeros_like(bhi))
        Md = port.mg_preconditioner(op, return_rdot=True)
        iters = []

        def solve_f32(r):
            res = port.cg(op.mv, r, rtol=1e-4, maxiter=40, precond_dot=Md,
                          matvec_dot=getattr(op, "mv_dot", None))
            iters.append(res.iters)
            return res.x

        re = tref.df_iterative_refinement(op, None, solve_f32, rtol=1e-8,
                                          b_df=b_df, return_host=False)
        for _ in range(2):
            rp = port.df_northstar_fused(op, b_df, rtol=1e-8, inner_rtol=1e-4)
            assert rp.converged and rp.pcg_iters == iters
            assert rp.passes == re.passes
            assert rp.syncs == sum(rp.pcg_iters) + 2 * rp.passes + 2
            for a, b in zip(rp.x, re.x):
                np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_2d_matches_jax(self):
        """A 2D case of the program against JAX's ``df_northstar_fused``:
        the same pass count, both to 1e-8 checked in f64 on the host."""
        n = 64
        rj = jref.df_northstar_fused(jpoisson.poisson2d(n, n), rtol=1e-8)
        b = jref.stencil2d_mv_np(n, n)(np.ones(n * n)).reshape(n, n)
        b_df = convert.df_pair_from_numpy(b.astype(np.float32),
                                          np.zeros_like(b, np.float32), "cpu")
        rt = port.df_northstar_fused(port.poisson2d(n, n), b_df, rtol=1e-8)
        assert rt.converged and rj.converged
        assert rt.passes == rj.passes <= 3
        mv = jref.stencil2d_mv_np(n, n)
        for x64 in (tdf.df_to_f64(rt.x), jdf.df_to_f64(rj.x)):
            rel = (np.linalg.norm(b.reshape(-1) - mv(x64.reshape(-1)))
                   / np.linalg.norm(b))
            assert rel <= 1e-8 and np.abs(x64 - 1.0).max() <= 1e-7


class TestCountedGraph:
    """``ops/build.CountedGraph`` with a stand-in for the CUDA graph: a
    capture launches nothing, so its counts are taken back out; every
    replay adds them again."""

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    def test_capture_and_replays(self):
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

        build.reset_launch_counts()
        build.launches["a"] += 2           # launched before the capture
        stand_in = self.Graph()
        g = build.CountedGraph(stand_in, contextlib.nullcontext)

        def body():
            build.launches["a"] += 1
            build.launches["b"] += 3
            return "out"

        assert g.capture(body) == "out"
        assert build.launch_counts() == {"a": 2}
        assert dict(g.launches) == {"a": 1, "b": 3}
        g.replay()
        g.replay()
        assert stand_in.replays == 2
        assert build.launch_counts() == {"a": 4, "b": 6}
        build.reset_launch_counts()


class TestConvert:
    def test_operator(self):
        jop = jpoisson.poisson3d(8, 4, 6)
        top = convert.from_jax_operator(jop)
        assert (top.nx, top.ny, top.nz, top.diag, top.off) == (
            8, 4, 6, 6.0, -1.0)
        top2 = convert.from_jax_operator(jpoisson.poisson2d(4, 5))
        assert (type(top2).__name__, top2.m, top2.n) == ("Stencil2D", 4, 5)
        jstrip = jpoisson.strip2d(4, 6)
        strip = convert.from_jax_operator(jstrip, "cpu")
        assert (type(strip).__name__, strip.rows, strip.n) == (
            "StencilStrip2D", 2, 6)
        x = np.random.default_rng(0).standard_normal(12)
        np.testing.assert_allclose(strip.mv(torch.from_numpy(x)).numpy(),
                                   np.asarray(jstrip.mv(jnp.asarray(x))),
                                   rtol=1e-12)

    def test_arrays(self):
        a = np.random.default_rng(1).standard_normal((3, 4, 5)).astype(np.float32)
        bf = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
        t = convert.tensor_from_numpy(bf, "cpu")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))
        np.testing.assert_array_equal(convert.tensor_from_numpy(a, "cpu").numpy(), a)
        hi, lo = jdf.df_from_f64(a.astype(np.float64) / 3.0)
        th, tl = convert.df_pair_from_numpy(np.asarray(hi), np.asarray(lo),
                                            "cpu")
        np.testing.assert_array_equal(th.numpy(), np.asarray(hi))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(lo))
        with pytest.raises(ValueError):
            convert.df_pair_from_numpy(a.astype(np.float64), a, "cpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


class TestBoundary:
    def test_port_imports_no_jax(self):
        files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        assert len(files) > 10
        for f in files:
            for mod in _imports(f):
                top = mod.split(".")[0]
                assert top != "jax", (f, mod)
                assert top != "medane_tchakorom_ufc_thesis_repository_tpu", (f, mod)

    def test_exports(self):
        assert set(port.__all__) == {
            "poisson3d", "Stencil3D", "cg", "mg_preconditioner",
            "df_northstar_fused",
            # slice 2
            "poisson2d", "Stencil2D", "gmres", "chebyshev", "StackedStencil2D",
            "StackedStencil3D", "block_poisson2d", "block_poisson3d",
            "rhs_ones", "final_residual_norm", "InnerConfig", "OuterConfig",
            "MultisplitResult", "multisplit_solve", "sm", "am", "smsm", "amam",
            # slice 3
            "solve", "prepare", "lstsq", "PreparedSolver", "DenseOp", "ELL",
            "DIA", "BSR", "AIJ", "operator_from_coo", "from_scipy",
            "as_routed_operator", "minres", "bicgstab", "default_device",
            # slice 4
            "residual_norm_sq", "iterative_refinement",
            "device_iterative_refinement", "df_iterative_refinement",
            # slice 8
            "BlockOperator", "StackedELLOperator", "StackedDIAOperator",
            "StackedBSROperator", "as_stacked_routed_operator",
            "from_stacked_ell", "stacked_bsr_from_ell", "block_poisson2d_ell",
            "block_split_ell", "StencilStrip2D", "StencilStrip3D", "strip2d",
            "strip3d"}

    def test_chip_smoke_refuses_without_a_card(self, tmp_path):
        assert not torch.cuda.is_available()
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        # the checkout's script and a lone copy, run side by side
        runs = [subprocess.Popen([sys.executable, str(cwd / "chip_smoke.py")],
                                 cwd=cwd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for cwd in (ROOT, tmp_path)]
        for p in runs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode != 0
            assert '"ok"' not in out
