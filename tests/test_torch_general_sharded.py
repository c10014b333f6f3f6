"""The port's row-sharded general-sparse solves (``parallel/general.py``)
on a ``(2, 4)`` ``'local'`` mesh on the CPU: the block-ELL strips
(``ShardedGeneralBSR``, kernel I's format) with the strip-local
block-Jacobi, and the CSR strips (``ShardedAIJ``, kernel H).

Against JAX's ``sharded_general_solve`` and ``sharded_aij_solve`` on its
8 virtual CPU devices, on the same matrices from numpy seeds, in f64:
iterations equal, x to 1e-8.  The JAX block-ELL operator's arrays and
block-Jacobi inverses cross over through ``convert.from_jax_operator``;
its AIJ keeps a Clos-routed plan that is not ported, so the port's is
built from the same COO triplets.  The other cases hold the port against
scipy and its own single-device solvers (JAX's
``tests/test_general_sharded.py``).  On the CPU the strips' products run
the plain versions of kernels I and H.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
    general as jgen,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch import convert
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    AIJ,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    make_mesh,
    make_tiled_mesh,
    shard_aij_from_coo,
    shard_bjacobi_from_coo,
    shard_general_from_coo,
    sharded_aij_solve,
    sharded_general_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel.general import (
    ShardedBlockJacobi,
    ShardedGeneralBSR,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh24():
    return make_mesh(2, 4, device=CPU)


def _spd(n=128, density=0.05, seed=0):
    """A sparse SPD matrix with a pattern that crosses every strip."""
    A = sp.random(n, n, density=density, random_state=seed).tocsr()
    return ((A @ A.T) + sp.eye(n) * 4.0).tocsr()


def _nonsym(n=128, seed=1):
    """A structureless, diagonally dominant nonsymmetric matrix."""
    A = sp.random(n, n, density=0.01, random_state=seed).tocsr()
    return (A + sp.eye(n) * (abs(A).sum(axis=1).max() + 1.0)).tocsr()


def _coo(A):
    c = A.tocoo()
    return c.row, c.col, c.data


def _rhs(A, seed=5):
    return np.random.default_rng(seed).standard_normal(A.shape[0])


# ---------------------------------------------------------------------------
# Against JAX's sharded functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(mesh8):
    A = _spd()
    r, c, v = _coo(A)
    b = _rhs(A)
    jop = jgen.shard_general_from_coo(r, c, v, 128, 8, c=8, dtype=jnp.float64)
    jpc = jgen.shard_bjacobi_from_coo(r, c, v, 128, 8, bs=8,
                                      dtype=jnp.float64)
    g = jgen.sharded_general_solve(mesh8, jop, jnp.asarray(b), rtol=1e-10)
    gp = jgen.sharded_general_solve(mesh8, jop, jnp.asarray(b), rtol=1e-10,
                                    method="cg", pc=jpc)
    N = _nonsym(1024)
    ra, ca, va = _coo(N)
    ba = _rhs(N, 6)
    jaij = jgen.shard_aij_from_coo(ra, ca, va, 1024, 8, dtype=jnp.float64)
    a = jgen.sharded_aij_solve(mesh8, jaij, jnp.asarray(ba), rtol=1e-10)
    return {"A": A, "b": b, "jop": jop, "jpc": jpc, "N": N, "ba": ba,
            "gmres": (int(g.iters), np.asarray(g.x)),
            "cg_pc": (int(gp.iters), np.asarray(gp.x)),
            "aij": (int(a.iters), np.asarray(a.x))}


class TestAgainstJax:
    def test_bsr_gmres(self, mesh24, jax_runs):
        iters, x = jax_runs["gmres"]
        op = convert.from_jax_operator(jax_runs["jop"], device=CPU)
        assert isinstance(op, ShardedGeneralBSR) and op.n == 128
        res = sharded_general_solve(mesh24, op,
                                    torch.from_numpy(jax_runs["b"]),
                                    rtol=1e-10)
        assert int(res.iters) == iters
        np.testing.assert_allclose(res.x.numpy(), x, rtol=0, atol=1e-8)

    def test_bsr_cg_bjacobi(self, mesh24, jax_runs):
        iters, x = jax_runs["cg_pc"]
        op = convert.from_jax_operator(jax_runs["jop"], device=CPU)
        pc = convert.from_jax_operator(jax_runs["jpc"], device=CPU)
        assert isinstance(pc, ShardedBlockJacobi) and pc.bs == 8
        res = sharded_general_solve(mesh24, op,
                                    torch.from_numpy(jax_runs["b"]),
                                    rtol=1e-10, method="cg", pc=pc)
        assert int(res.iters) == iters
        np.testing.assert_allclose(res.x.numpy(), x, rtol=0, atol=1e-8)

    def test_aij_gmres(self, mesh24, jax_runs):
        iters, x = jax_runs["aij"]
        op = shard_aij_from_coo(*_coo(jax_runs["N"]), 1024, 8,
                                dtype=torch.float64, device=CPU)
        res = sharded_aij_solve(mesh24, op, torch.from_numpy(jax_runs["ba"]),
                                rtol=1e-10)
        assert int(res.iters) == iters
        np.testing.assert_allclose(res.x.numpy(), x, rtol=0, atol=1e-8)

    def test_pack_matches_jax(self, jax_runs):
        r, c, v = _coo(jax_runs["A"])
        op = shard_general_from_coo(r, c, v, 128, 8, c=8,
                                    dtype=torch.float64, device=CPU)
        np.testing.assert_array_equal(op.idx.numpy(),
                                      np.asarray(jax_runs["jop"].idx))
        np.testing.assert_array_equal(op.val.numpy(),
                                      np.asarray(jax_runs["jop"].val))


# ---------------------------------------------------------------------------
# The port's own cases (JAX's tests/test_general_sharded.py)
# ---------------------------------------------------------------------------

class TestShardedGeneralBSR:
    @pytest.mark.parametrize("c", [4, 8])
    def test_solution_matches_scipy(self, mesh24, c):
        """Block size 8 runs kernel I's format, 4 the plain product."""
        A = _spd()
        b = _rhs(A)
        op = shard_general_from_coo(*_coo(A), 128, 8, c=c,
                                    dtype=torch.float64, device=CPU)
        res = sharded_general_solve(mesh24, op, torch.from_numpy(b),
                                    rtol=1e-12)
        np.testing.assert_allclose(res.x.numpy(), spla.spsolve(A.tocsc(), b),
                                   rtol=1e-9, atol=1e-10)

    @pytest.mark.parametrize("method", ["gmres", "cg", "bicgstab"])
    def test_solve_on_mesh_matches_scipy(self, mesh24, method):
        A = _spd()
        b = _rhs(A)
        op = shard_general_from_coo(*_coo(A), 128, 8, dtype=torch.float64,
                                    device=CPU)
        res = sharded_general_solve(mesh24, op, torch.from_numpy(b),
                                    method=method, rtol=1e-10)
        assert bool(res.converged)
        np.testing.assert_allclose(res.x.numpy(), spla.spsolve(A.tocsc(), b),
                                   rtol=1e-7, atol=1e-8)

    def test_iteration_parity_with_single_device(self, mesh24):
        A = _spd()
        b = _rhs(A)
        op = shard_general_from_coo(*_coo(A), 128, 8, dtype=torch.float64,
                                    device=CPU)
        res = sharded_general_solve(mesh24, op, torch.from_numpy(b),
                                    rtol=1e-10)
        aij = AIJ.from_coo(*_coo(A), A.shape, dtype=torch.float64,
                           device=CPU)
        ref = krylov.gmres(aij.mv, torch.from_numpy(b), rtol=1e-10)
        assert int(res.iters) == int(ref.iters)

    def test_device_count_mismatch_raises(self, mesh24):
        A = _spd(64)
        op = shard_general_from_coo(*_coo(A), 64, 4, dtype=torch.float64,
                                    device=CPU)
        with pytest.raises(ValueError, match="packed for 4"):
            sharded_general_solve(mesh24, op, torch.zeros(64,
                                                          dtype=torch.float64))
        with pytest.raises(ValueError, match="method"):
            sharded_general_solve(mesh24, op, torch.zeros(64), method="lu")

    @pytest.mark.parametrize("method", ["gmres", "cg", "bicgstab"])
    def test_pc_accelerates_and_matches_scipy(self, mesh24, method):
        A = _spd(128, density=0.03, seed=3) + sp.diags(
            np.linspace(1, 50, 128))
        A = A.tocsr()
        b = _rhs(A)
        r, c, v = _coo(A)
        op = shard_general_from_coo(r, c, v, 128, 8, dtype=torch.float64,
                                    device=CPU)
        pc = shard_bjacobi_from_coo(r, c, v, 128, 8, bs=16,
                                    dtype=torch.float64, device=CPU)
        plain = sharded_general_solve(mesh24, op, torch.from_numpy(b),
                                      method=method, rtol=1e-10)
        pre = sharded_general_solve(mesh24, op, torch.from_numpy(b),
                                    method=method, rtol=1e-10, pc=pc)
        assert bool(pre.converged)
        assert int(pre.iters) <= int(plain.iters)
        np.testing.assert_allclose(pre.x.numpy(), spla.spsolve(A.tocsc(), b),
                                   rtol=1e-7, atol=1e-8)

    def test_pc_block_must_fit_strip(self):
        A = _spd(64)
        with pytest.raises(ValueError, match="straddle"):
            shard_bjacobi_from_coo(*_coo(A), 64, 8, bs=16)
        with pytest.raises(ValueError, match="divisible"):
            shard_general_from_coo(*_coo(A), 64, 8, c=16)

    def test_tiled_mesh(self):
        mesh = make_tiled_mesh(2, 2, 2, device=CPU)
        A = _spd()
        b = _rhs(A)
        op = shard_general_from_coo(*_coo(A), 128, 8, dtype=torch.float64,
                                    device=CPU)
        res = sharded_general_solve(mesh, op, torch.from_numpy(b),
                                    method="cg", rtol=1e-10)
        np.testing.assert_allclose(res.x.numpy(), spla.spsolve(A.tocsc(), b),
                                   rtol=1e-7, atol=1e-8)


class TestShardedAIJ:
    def test_strip_rows_match_scipy(self, mesh24):
        N = _nonsym(1024)
        op = shard_aij_from_coo(*_coo(N), 1024, 8, dtype=torch.float64,
                                device=CPU)
        indptr, indices, data, part = op.rows(2, 3)
        x = np.random.default_rng(9).standard_normal(1024)
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.csr import (
            csr_mv,
        )

        y = csr_mv(indptr, indices, data, torch.from_numpy(x), 3 * 128,
                   1024, partition=part)
        np.testing.assert_allclose(y.numpy(), (N @ x)[256:640], rtol=1e-13)

    @pytest.mark.parametrize("method", ["cg", "gmres", "bicgstab"])
    def test_solve_on_mesh(self, mesh24, method):
        A = _spd(1024, density=0.004, seed=2)
        b = _rhs(A)
        op = shard_aij_from_coo(*_coo(A), 1024, 8, dtype=torch.float64,
                                device=CPU)
        res = sharded_aij_solve(mesh24, op, torch.from_numpy(b),
                                method=method, rtol=1e-10)
        assert bool(res.converged)
        np.testing.assert_allclose(res.x.numpy(), spla.spsolve(A.tocsc(), b),
                                   rtol=1e-7, atol=1e-8)

    def test_indivisible_rejected(self):
        with pytest.raises(ValueError, match="divisible"):
            shard_aij_from_coo(*_coo(_spd(60)), 60, 8)
