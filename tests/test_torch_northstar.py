"""Port parity for the slice as a whole: the double-float-refined MG-PCG
north-star (``solvers/refine.py``), the state carried across from JAX
(``convert.py``), the package boundary, and ``chip_smoke.py``'s refusal
to run without a card."""

import ast
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


class TestConvert:
    def test_operator(self):
        jop = jpoisson.poisson3d(8, 4, 6)
        top = convert.from_jax_operator(jop)
        assert (top.nx, top.ny, top.nz, top.diag, top.off) == (
            8, 4, 6, 6.0, -1.0)
        top2 = convert.from_jax_operator(jpoisson.poisson2d(4, 5))
        assert (type(top2).__name__, top2.m, top2.n) == ("Stencil2D", 4, 5)
        with pytest.raises(TypeError):   # the strip operators are not ported
            convert.from_jax_operator(jpoisson.strip2d(4, 4))

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
            "as_routed_operator", "minres", "bicgstab", "default_device"}

    def test_chip_smoke_refuses_without_a_card(self, tmp_path):
        assert not torch.cuda.is_available()
        for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                            (tmp_path, tmp_path / "chip_smoke.py")):
            if cwd == tmp_path:
                script.write_text((ROOT / "chip_smoke.py").read_text())
            p = subprocess.run([sys.executable, str(script)], cwd=cwd,
                               capture_output=True, text=True, timeout=120)
            assert p.returncode != 0
            assert '"ok"' not in p.stdout
