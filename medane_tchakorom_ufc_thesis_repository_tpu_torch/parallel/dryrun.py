"""The multi-device dry run: one pass over every sharded path on tiny
shapes, each checked (the twin of the JAX package's
``__graft_entry__.dryrun_multichip``), on the ``'local'`` transport.

``dryrun_multichip(n)`` prints seven ``... OK`` lines: the sharded
AMAM_GLOBAL step against the stacked solver, the MG-PCG north-star (host
loop and device-tested loop) to 1e-8, the tiled-mesh north-star and
multisplitting step, the row-sharded general-sparse (block-ELL) and AIJ
(CSR) solves.
"""

from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run one sharded step of each path over an ``n_devices``-shard mesh
    ``(2, n_devices // 2)`` on ``device`` (None: the current CUDA device)
    and assert it is right."""
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import (
        resolve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
        blockops,
        multisplitting as ms,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
        InnerConfig,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.parallel import (
        ShardedPoisson2D,
        ShardedPoisson3D,
        make_mesh,
        make_tiled_mesh,
        shard_aij_from_coo,
        shard_general_from_coo,
        sharded_aij_solve,
        sharded_df_northstar,
        sharded_df_northstar_fused,
        sharded_general_solve,
        sharded_multisplit_solve,
        tiled_multisplit_solve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import df64

    dev = resolve(device)
    if n_devices % 2:
        raise ValueError("need an even number of devices for 2 Jacobi blocks")
    nblocks, intra = 2, n_devices // 2
    mesh = make_mesh(nblocks, intra, device=dev)

    # one cycle of AMAM_GLOBAL: s sweeps of inner GMRES, async publishing,
    # the global minimization (maxiter=s stops after one outer cycle)
    m, n = 2 * n_devices, 16
    sop = blockops.block_poisson2d(m, n, nblocks=nblocks)
    b = blockops.rhs_ones(sop, torch.float32, dev)
    kw = dict(schedule="async", staleness=2, minimization="global", s=2,
              inner=InnerConfig(restart=8, maxiter=8), rtol=1e-10, maxiter=2)
    res = sharded_multisplit_solve(mesh, ShardedPoisson2D(m, n),
                                   b.reshape(m, n), **kw)
    x = res.x.cpu().numpy()
    assert x.shape == (m, n), x.shape
    assert np.isfinite(x).all(), "non-finite values in dry-run solution"
    assert res.sweeps == 2, res.sweeps
    # the same configuration on the stacked single-device solver: the
    # same mathematics in another layout (an unconverged async run takes
    # no certification tail, so the counts compare as they are)
    res_st = ms.multisplit_solve(sop, b, **kw)
    assert res_st.sweeps == res.sweeps, (res_st.sweeps, res.sweeps)
    np.testing.assert_allclose(x.reshape(-1),
                               res_st.x.cpu().numpy().reshape(-1),
                               rtol=1e-4, atol=1e-5)
    rn, rn_st = float(res.rnorm), float(res_st.rnorm)
    np.testing.assert_allclose(rn, rn_st, rtol=1e-4)
    print(f"dryrun_multichip OK: mesh=({nblocks}x{intra}), grid={m}x{n}, "
          f"sweeps={res.sweeps}, rnorm={rn:.3e} (matches stacked "
          f"{rn_st:.3e})")

    # the north-star over the mesh: MG-PCG + double-float refinement to
    # 1e-8 relative TRUE residual, the solution checked in f64 on the host
    nx = 16 if 16 % n_devices == 0 else 2 * n_devices
    cfg3 = ShardedPoisson3D(nx, 16, 16)
    res_ns = sharded_df_northstar(mesh, cfg3, rtol=1e-8)
    assert res_ns.converged, (
        f"north-star did not reach 1e-8: {res_ns.rel_history}")
    err = np.abs(df64.df_to_f64(res_ns.x) - 1.0).max()
    assert err < 1e-6, err
    print(f"dryrun mgpcg north-star OK: grid={nx}x16x16, "
          f"passes={res_ns.passes}, rel={res_ns.rnorm / res_ns.rnorm0:.2e}")

    res_f = sharded_df_northstar_fused(mesh, cfg3, rtol=1e-8)
    assert res_f.converged, (f"fused north-star did not reach 1e-8: rel="
                             f"{res_f.rnorm / res_f.rnorm0:.2e}")
    err = np.abs(df64.df_to_f64(res_f.x) - 1.0).max()
    assert err < 1e-6, err
    print(f"dryrun fused north-star OK: passes={res_f.passes}, "
          f"rel={res_f.rnorm / res_f.rnorm0:.2e}")

    if intra % 2 == 0:
        tmesh = make_tiled_mesh(nblocks, intra // 2, 2, device=dev)
        res_tns = sharded_df_northstar(tmesh, cfg3, rtol=1e-8)
        assert res_tns.converged, (
            f"tiled north-star did not reach 1e-8: {res_tns.rel_history}")
        err = np.abs(df64.df_to_f64(res_tns.x) - 1.0).max()
        assert err < 1e-6, err
        print(f"dryrun tiled mgpcg north-star OK: "
              f"mesh=({nblocks}x{intra // 2}x2), passes={res_tns.passes}, "
              f"rel={res_tns.rnorm / res_tns.rnorm0:.2e}")

        res_t = tiled_multisplit_solve(
            tmesh, m, 16, b.reshape(m, n), schedule="sync",
            minimization="global", s=2,
            inner=InnerConfig(restart=8, maxiter=8), rtol=1e-10, maxiter=2)
        assert torch.isfinite(res_t.x).all(), "non-finite tiled dry run"
        print(f"dryrun tiled OK: mesh=({nblocks}x{intra // 2}x2), "
              f"sweeps={res_t.sweeps}")

    # row-sharded general sparse (MPIAIJ across ranks): all-gathered
    # matvec, mesh-reduced Krylov dots
    ng = 8 * n_devices
    Ag = sp.random(ng, ng, density=0.05, random_state=0).tocsr()
    Ag = (Ag @ Ag.T) + sp.eye(ng) * ng
    coo = Ag.tocoo()
    gop = shard_general_from_coo(coo.row, coo.col, coo.data, ng, n_devices,
                                 c=4, dtype=torch.float32, device=dev)
    bg = torch.tensor(Ag @ np.ones(ng), dtype=torch.float32, device=dev)
    res_g = sharded_general_solve(mesh, gop, bg, method="gmres", rtol=1e-5,
                                  maxiter=500)
    assert bool(res_g.converged), "general-sparse sharded solve diverged"
    assert float((res_g.x - 1.0).abs().max()) < 1e-2
    print(f"dryrun general-sparse OK: n={ng}, iters={int(res_g.iters)}, "
          f"rel={float(res_g.resnorm / res_g.resnorm0):.2e}")

    # row-sharded AIJ: one CSR strip a shard, kernel H
    na = 1024 * n_devices
    Ba = sp.random(na, na, density=0.002, random_state=2)
    Sa = (Ba + Ba.T) * 0.5
    Sa = Sa + sp.eye(na) * (abs(Sa).sum(axis=1).max() + 1.0)
    coo = Sa.tocoo()
    aop = shard_aij_from_coo(coo.row, coo.col, coo.data, na, n_devices,
                             dtype=torch.float32, device=dev)
    ba = torch.tensor(Sa @ np.ones(na), dtype=torch.float32, device=dev)
    res_a = sharded_aij_solve(mesh, aop, ba, method="cg", rtol=1e-5,
                              maxiter=300)
    assert bool(res_a.converged), "sharded AIJ solve diverged"
    assert float((res_a.x - 1.0).abs().max()) < 1e-2
    print(f"dryrun sharded-AIJ OK: n={na}, iters={int(res_a.iters)}, "
          f"rel={float(res_a.resnorm / res_a.resnorm0):.2e}")
