"""The port's mesh and its collectives (``parallel/mesh.py``), the
solvers' reducer hooks, and the probes.

Both transports are held against numpy: ``'local'`` in this process on a
``(2, 4)`` mesh (the shape of the JAX tests' 8 virtual devices) and a
``(2, 2, 2)`` mesh, ``'dist'`` in 2 and 4 gloo ranks on the CPU, each
rank printing its shards' results as JSON (every rank case runs under a
60 s limit: a collective out of lockstep hangs).  The reducer hooks
(``axis_name`` with the port's ``mesh``) are held against the unsharded
solvers on a one-shard mesh; ``axis_name=None`` leaves the solvers as
they were, which the golden counts of ``test_torch_multisplitting.py``
and the north-star's PCG pins of ``test_torch_northstar.py`` guard.  The
simplest whole-mesh programs, the sharded GMRES and CA-GMRES of
``parallel/sharded.py`` (every dot a psum over both axes, every apply a
halo exchange), are held against JAX's on its 8 virtual CPU devices:
iterations equal, x to 1e-8, f64, 16x16.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    blockops as jbo,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
    sharded as jsh,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    Stencil2D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    Mesh,
    ShardedPoisson2D,
    make_mesh,
    make_tiled_mesh,
    measure_collective_latency,
    measure_dispatch_latency,
    sharded_ca_gmres_solve,
    sharded_gmres_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import (
    castep,
    chebyshev as cheb,
    df64,
    krylov,
    lsqr as lsqr_mod,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import multihost

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(2, 4, transport="local", device=CPU)


def _data(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape))


# ---------------------------------------------------------------------------
# 'local' transport against numpy
# ---------------------------------------------------------------------------

class TestLocalCollectives:
    def test_layout(self, mesh):
        assert mesh.shape == {"block": 2, "intra": 4}
        assert mesh.local_shape == (2, 4) and mesh.nlocal == 8
        assert mesh.size == 8 and mesh.axis_names == ("block", "intra")

    @pytest.mark.parametrize("axes", [("intra",), ("block",),
                                      ("block", "intra")])
    def test_psum(self, mesh, axes):
        x = _data((2, 4, 5))
        dims = tuple(mesh.axis_names.index(a) for a in axes)
        want = np.broadcast_to(x.numpy().sum(axis=dims, keepdims=True),
                               x.shape)
        np.testing.assert_allclose(mesh.psum(x, axes).numpy(), want,
                                   rtol=1e-15)

    def test_two_level_order(self, mesh):
        """A sum over both axes is 'intra' first, then 'block'."""
        x = _data((2, 4, 3), seed=1)
        want = x.sum(dim=1, keepdim=True).sum(dim=0, keepdim=True)
        assert torch.equal(mesh.psum(x, ("block", "intra"))[0, 0],
                           want[0, 0])

    def test_pmax_pmean(self, mesh):
        x = _data((2, 4, 3), seed=2)
        np.testing.assert_array_equal(
            mesh.pmax(x, "intra").numpy(),
            np.broadcast_to(x.numpy().max(axis=1, keepdims=True), x.shape))
        np.testing.assert_allclose(
            mesh.pmean(x, "block").numpy(),
            np.broadcast_to(x.numpy().mean(axis=0, keepdims=True), x.shape),
            rtol=1e-14)

    @pytest.mark.parametrize("axis,pairs", [
        ("intra", [(0, 1), (1, 2), (2, 3)]),
        ("intra", [(3, 0)]),
        ("block", [(0, 1)]),
        ("block", [(0, 1), (1, 0)]),
    ])
    def test_ppermute(self, mesh, axis, pairs):
        x = _data((2, 4, 6), seed=3)
        d = mesh.axis_names.index(axis)
        want = np.zeros(x.shape)
        for s, t in pairs:
            idx_s = [slice(None)] * 3
            idx_t = [slice(None)] * 3
            idx_s[d], idx_t[d] = s, t
            want[tuple(idx_t)] = x.numpy()[tuple(idx_s)]
        np.testing.assert_array_equal(mesh.ppermute(x, axis, pairs).numpy(),
                                      want)

    @pytest.mark.parametrize("tiled", [False, True])
    def test_all_gather_both_axes(self, mesh, tiled):
        x = _data((2, 4, 3, 2), seed=4)
        g = mesh.all_gather(x, ("block", "intra"), axis=0, tiled=tiled)
        stack = x.numpy().reshape(8, 3, 2)
        want = stack.reshape(24, 2) if tiled else stack
        for i in range(2):
            for j in range(4):
                np.testing.assert_array_equal(g[i, j].numpy(), want)

    def test_all_gather_one_axis(self, mesh):
        x = _data((2, 4, 3), seed=5)
        g = mesh.all_gather(x, "block", axis=0)
        for i in range(2):
            for j in range(4):
                np.testing.assert_array_equal(g[i, j].numpy(),
                                              x[:, j].numpy())

    def test_axis_index(self, mesh):
        np.testing.assert_array_equal(mesh.axis_index("intra").numpy(),
                                      np.tile(np.arange(4), (2, 1)))
        np.testing.assert_array_equal(mesh.shard_index().numpy(),
                                      np.arange(8).reshape(2, 4))

    @pytest.mark.parametrize("spec,shape", [
        ((("block", "intra"),), (16, 5)),
        ((("block", "intra"),), (8, 3, 2)),
    ])
    def test_shard_roundtrip(self, mesh, spec, shape):
        g = _data(shape, seed=6)
        xs = mesh.shard(g, spec)
        assert xs.shape[:2] == (2, 4)
        # shard (i, j) holds rows of strip i * 4 + j
        rows = shape[0] // 8
        np.testing.assert_array_equal(xs[1, 2].numpy(),
                                      g[6 * rows:7 * rows].numpy())
        assert torch.equal(mesh.unshard(xs, spec, shape), g)

    def test_tiled_shard_roundtrip(self):
        tm = make_tiled_mesh(2, 2, 2, device=CPU)
        g = _data((8, 6, 3), seed=7)
        spec = (("block", "ir"), "ic")
        xs = tm.shard(g, spec)
        assert xs.shape == (2, 2, 2, 2, 3, 3)
        np.testing.assert_array_equal(xs[1, 0, 1].numpy(),
                                      g[4:6, 3:6].numpy())
        assert torch.equal(tm.unshard(xs, spec, g.shape), g)

    def test_reducer_flattens_shards(self, mesh):
        p = _data((8, 3), seed=8)
        red = mesh.reducer("intra")(p)
        want = p.reshape(2, 4, 3).sum(1, keepdim=True).expand(2, 4, 3)
        assert torch.equal(red, want.reshape(8, 3))

    def test_bad_transport_and_axis(self):
        with pytest.raises(ValueError, match="transport"):
            Mesh(("block",), (2,), transport="nccl", device=CPU)
        with pytest.raises(ValueError, match="no mesh axis"):
            make_mesh(2, 2, device=CPU).psum(torch.zeros(2, 2), "ic")

    def test_dist_needs_init(self):
        with pytest.raises(RuntimeError, match="init_multihost"):
            make_mesh(2, 1, transport="dist", device=CPU)


# ---------------------------------------------------------------------------
# 'dist' transport: gloo ranks on the CPU against the 'local' mesh
# ---------------------------------------------------------------------------

_RANK = r"""
import json, sys, torch
from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
    init_multihost, make_mesh)
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_multihost(f"localhost:{port}", world, rank, backend="gloo")
mesh = make_mesh(2, 4, transport="dist", device="cpu")
g = torch.arange(8 * 3, dtype=torch.float64).reshape(8, 3) ** 1.5
x = mesh.shard(g, (("block", "intra"),))
out = {"local_shape": list(mesh.local_shape),
       "psum_all": mesh.psum(x, ("block", "intra")).tolist(),
       "psum_intra": mesh.psum(x, "intra").tolist(),
       "pmax_block": mesh.pmax(x, "block").tolist(),
       "pp_intra": mesh.ppermute(x, "intra", [(0, 1), (1, 2), (2, 3),
                                             (3, 0)]).tolist(),
       "pp_block": mesh.ppermute(x, "block", [(0, 1)]).tolist(),
       "gather": mesh.all_gather(x, ("block", "intra"), axis=0,
                                 tiled=True).tolist(),
       "gather_block": mesh.all_gather(x, "block").tolist(),
       "index": mesh.shard_index().tolist(),
       "unshard": mesh.unshard(x, (("block", "intra"),), (8, 3)).tolist()}
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(json.dumps(out), flush=True)
"""


def _local_expectations():
    mesh = make_mesh(2, 4, device=CPU)
    g = torch.arange(8 * 3, dtype=torch.float64).reshape(8, 3) ** 1.5
    x = mesh.shard(g, (("block", "intra"),))
    return mesh, g, {
        "psum_all": mesh.psum(x, ("block", "intra")),
        "psum_intra": mesh.psum(x, "intra"),
        "pmax_block": mesh.pmax(x, "block"),
        "pp_intra": mesh.ppermute(x, "intra", [(0, 1), (1, 2), (2, 3),
                                               (3, 0)]),
        "pp_block": mesh.ppermute(x, "block", [(0, 1)]),
        "gather": mesh.all_gather(x, ("block", "intra"), axis=0, tiled=True),
        "gather_block": mesh.all_gather(x, "block"),
        "index": mesh.shard_index()}


@pytest.mark.parametrize("world", [2, 4])
def test_dist_collectives_match_local(world):
    """Each rank's shards hold what the same shards hold on the 'local'
    mesh, to the bit (two ranks along 'block' sum in the local order; an
    'intra' split over processes sums pairs, still exact on these
    integers' powers at f64 to the rounding the test allows)."""
    port = multihost.free_port()
    cmds = [[sys.executable, "-c", _RANK, str(r), str(world), str(port)]
            for r in range(world)]
    outs = multihost.run_ranks(cmds, multihost.scrubbed_env("cpu"),
                               timeout_s=60.0, label="mesh ranks")
    mesh, g, want = _local_expectations()
    per = 8 // world
    for r, out in enumerate(outs):
        lb, li = (1, 4) if world == 2 else (1, 2)
        assert out["local_shape"] == [lb, li]
        blk, i0 = (r, 0) if world == 2 else (r // 2, (r % 2) * 2)
        sl = (slice(blk, blk + 1), slice(i0, i0 + li))
        for key, ref in want.items():
            np.testing.assert_allclose(np.asarray(out[key]),
                                       ref[sl].numpy(), rtol=1e-15,
                                       err_msg=f"{key} rank {r}")
        np.testing.assert_array_equal(np.asarray(out["unshard"]), g.numpy())
        assert per * len(outs) == 8


# ---------------------------------------------------------------------------
# The reducer hooks of the solvers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one():
    return make_mesh(1, 1, device=CPU)


def _system(m=12, n=12):
    op = Stencil2D(m, n)
    b = torch.from_numpy(np.random.default_rng(11).standard_normal(m * n))
    return op, b


class TestReducerHooks:
    AXES = ("block", "intra")

    def test_make_reducer(self, one):
        v = torch.arange(3.0)
        assert krylov.make_reducer(None)(v) is v
        with pytest.raises(ValueError, match="mesh"):
            krylov.make_reducer("intra")
        assert torch.equal(krylov.make_reducer(self.AXES, one)(v[None]),
                           v[None])

    def test_cg(self, one):
        op, b = _system()
        ref = krylov.cg(op.mv, b, rtol=1e-10, maxiter=500)
        sh = krylov.cg(lambda v: op.mv(v[0])[None], b[None], rtol=1e-10,
                       maxiter=500, axis_name=self.AXES, mesh=one)
        assert int(sh.iters[0]) == ref.iters
        np.testing.assert_allclose(sh.x[0].numpy(), ref.x.numpy(),
                                   rtol=1e-10, atol=1e-12)

    def test_gmres(self, one):
        op, b = _system()
        ref = krylov.gmres(op.mv, b, restart=10, rtol=1e-10, maxiter=500)
        sh = krylov.gmres(lambda v: op.mv(v[0])[None], b[None], restart=10,
                          rtol=1e-10, maxiter=500, axis_name=self.AXES,
                          mesh=one)
        assert int(sh.iters[0]) == int(ref.iters)
        np.testing.assert_allclose(sh.x[0].numpy(), ref.x.numpy(),
                                   rtol=1e-10, atol=1e-12)

    def test_chebyshev_bit_equal(self, one):
        """The steps take no reduction: the iterate is the same to the
        bit, only the two norms are reduced."""
        op, b = _system()
        lo, hi = cheb.poisson_strip_eig_bounds_2d(12, 12)
        ref = cheb.chebyshev(op.mv, b, lmin=lo, lmax=hi, maxiter=15)
        sh = cheb.chebyshev(lambda v: op.mv(v[0])[None], b[None], lmin=lo,
                            lmax=hi, maxiter=15, axis_name=self.AXES,
                            mesh=one)
        assert torch.equal(sh.x[0], ref.x)
        np.testing.assert_allclose(sh.resnorm[0].item(), ref.resnorm.item(),
                                   rtol=1e-14)

    @pytest.mark.parametrize("method", ["bicgstab", "minres"])
    def test_short_recurrences(self, one, method):
        op, b = _system()
        solve = getattr(krylov, method)
        ref = solve(op.mv, b, rtol=1e-10, maxiter=500)
        sh = solve(lambda v: op.mv(v[0])[None], b[None], rtol=1e-10,
                   maxiter=500, axis_name=self.AXES, mesh=one)
        assert int(sh.iters[0]) == int(ref.iters)
        np.testing.assert_allclose(sh.x[0].numpy(), ref.x.numpy(),
                                   rtol=1e-9, atol=1e-11)

    def test_ca_gmres_single(self, one):
        op, b = _system()
        lo, hi = cheb.poisson_strip_eig_bounds_2d(12, 12)
        ref = castep.ca_gmres(op.mv, b, s=6, rtol=1e-9, maxiter=600, lmin=lo,
                              lmax=hi, reductions="single")
        sh = castep.ca_gmres(lambda v: op.mv(v[0])[None], b[None], s=6,
                             rtol=1e-9, maxiter=600, lmin=lo, lmax=hi,
                             reductions="single", axis_name=self.AXES,
                             mesh=one)
        assert int(sh.iters[0]) == int(ref.iters)
        np.testing.assert_allclose(sh.x[0].numpy(), ref.x.numpy(),
                                   rtol=1e-8, atol=1e-10)

    def test_lsqr(self, one):
        rng = np.random.default_rng(12)
        R = torch.from_numpy(rng.standard_normal((40, 5)))
        t = torch.from_numpy(rng.standard_normal(40))
        ref = lsqr_mod.lsqr(lambda a: R @ a, lambda u: R.T @ u, t, n=5,
                            rtol=1e-12, maxiter=50)
        sh = lsqr_mod.lsqr(lambda a: (R @ a[0])[None],
                           lambda u: (R.T @ u[0])[None], t[None], n=5,
                           rtol=1e-12, maxiter=50, axis_name=self.AXES,
                           mesh=one)
        assert int(sh.iters) == int(ref.iters)
        np.testing.assert_allclose(sh.x[0].numpy(), ref.x.numpy(),
                                   rtol=1e-10)

    def test_sharded_b_shape(self, one):
        op, b = _system()
        with pytest.raises(ValueError, match="shards"):
            krylov.gmres(op.mv, b, axis_name=self.AXES, mesh=one)

    def test_scaled_norm_axes(self, mesh):
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(
            (16, 6)).astype(np.float32) * 1e-11)
        xs = mesh.shard(x, (("block", "intra"),))
        got = df64.scaled_norm(xs, ("block", "intra"), mesh)
        assert got.shape == (2, 4)
        assert torch.equal(got, got[0, 0].expand(2, 4))
        np.testing.assert_allclose(got[0, 0].item(),
                                   df64.scaled_norm(x).item(), rtol=1e-6)
        with pytest.raises(ValueError, match="mesh"):
            df64.scaled_norm(xs, "intra")


# ---------------------------------------------------------------------------
# Whole-mesh programs against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_krylov(mesh8):
    """JAX's sharded GMRES and CA-GMRES on 16x16, f64."""
    b = jbo.rhs_ones(jbo.block_poisson2d(16, 16), jnp.float64).reshape(16, 16)
    cfg = jsh.ShardedPoisson2D(16, 16)
    gm = jsh.sharded_gmres_solve(mesh8, cfg, b, restart=20, rtol=1e-8)
    ca = jsh.sharded_ca_gmres_solve(mesh8, cfg, b, s=8, rtol=1e-8)
    return {"b": np.array(b), "gmres": (int(gm.iters), np.asarray(gm.x)),
            "ca": (int(ca.iters), np.asarray(ca.x))}


class TestWholeMeshAgainstJax:
    def test_gmres(self, mesh, jax_krylov):
        iters, x = jax_krylov["gmres"]
        res = sharded_gmres_solve(mesh, ShardedPoisson2D(16, 16),
                                  torch.from_numpy(jax_krylov["b"]),
                                  restart=20, rtol=1e-8)
        assert int(res.iters) == iters
        np.testing.assert_allclose(res.x.numpy(), x, rtol=1e-8, atol=1e-8)

    def test_ca_gmres(self, mesh, jax_krylov):
        iters, x = jax_krylov["ca"]
        res = sharded_ca_gmres_solve(mesh, ShardedPoisson2D(16, 16),
                                     torch.from_numpy(jax_krylov["b"]), s=8,
                                     rtol=1e-8)
        assert int(res.iters) == iters
        np.testing.assert_allclose(res.x.numpy(), x, rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

class TestProbes:
    @pytest.mark.parametrize("axis", ["block", "intra"])
    def test_collective_latency(self, mesh, axis):
        out = measure_collective_latency(mesh, axis, payload_floats=64,
                                         rounds=5)
        assert out["rounds"] == 5 and out["payload_bytes"] == 256
        assert out["per_round_us"] > 0 and out["gbytes_per_s"] > 0

    def test_single_shard_axis(self):
        out = measure_collective_latency(make_mesh(1, 2, device=CPU))
        assert out["rounds"] == 0

    def test_dispatch_latency(self):
        out = measure_dispatch_latency(samples=5, device=CPU)
        assert out["samples"] == 5 and out["median_us"] > 0
        assert json.dumps(out)
