"""Port parity for the host-driven, genuinely asynchronous backend
(``models/host_async.py``): one thread per block, drain-to-newest
mailboxes, Alg-5.15 termination, the lockstep certification tail.

The cases of the JAX package's ``tests/test_host_async.py`` run on the
port at 32², f64, on the CPU.  Threads race, so, as there, the
assertions are invariants (converged, certified, the merged residual
under rtol), not counts.  The certification tail is deterministic:
``_sync_certify`` on the same ``x`` must give JAX's ``certified`` and
``rounds``, and ``x`` to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.models import host_async as jha
from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
    InnerConfig as JInnerConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    host_async as tha,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    multisplitting as ms,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)


def _problem(m=32, n=32, nblocks=2):
    op = blockops.block_poisson2d(m, n, nblocks)
    return op, blockops.rhs_ones(op, torch.float64, "cpu")


def _check_residual(res, op, b, rtol, slack=2.0):
    """Certified runs satisfy the merged bound exactly; only an
    uncertified exit falls back to the async-slack bound.  The residual
    is measured again here on the returned x."""
    rel = float(torch.linalg.norm(b - op.full_mv(res.x))) / res.rnorm0
    assert rel == pytest.approx(res.rnorm / res.rnorm0, rel=1e-12)
    if res.certified:
        assert rel <= rtol * (1 + 1e-12)
    else:
        assert rel <= slack * rtol


class TestHostAsync:
    def test_am_converges(self):
        op, b = _problem()
        res = tha.host_async_solve(op, b, rtol=1e-3, maxiter=3000)
        assert res.converged and res.certified
        assert res.x.shape == (2, 512) and res.x.dtype == torch.float64
        assert all(s > 0 for s in res.sweeps_per_block)
        _check_residual(res, op, b, 1e-3)

    def test_heterogeneous_speeds(self):
        # one block slower: the fast one iterates on stale data
        op, b = _problem()
        res = tha.host_async_solve(op, b, rtol=1e-3, maxiter=3000,
                                   sweep_delay_s=[0.0, 0.01])
        assert res.converged
        _check_residual(res, op, b, 1e-3)

    @pytest.mark.parametrize("scope", ["local", "semi_local", "global"])
    def test_amam(self, scope):
        op, b = _problem()
        res = tha.host_async_solve(op, b, rtol=1e-3, maxiter=3000,
                                   minimization=scope, s=4)
        assert res.converged
        _check_residual(res, op, b, 1e-3)

    def test_maxiter_budget_respected(self):
        op, b = _problem()
        res = tha.host_async_solve(op, b, rtol=1e-14, maxiter=10)
        assert not res.converged and not res.certified
        assert all(c <= 10 for c in res.sweeps_per_block)


class TestRejects:
    def test_unknown_minimization(self):
        op, b = _problem(8, 8)
        with pytest.raises(ValueError, match="minimization"):
            tha.host_async_solve(op, b, minimization="bogus")

    def test_inner_pc(self):
        op, b = _problem(8, 8)
        with pytest.raises(ValueError, match="preconditioning"):
            tha.host_async_solve(op, b, inner=ms.InnerConfig(pc="jacobi"))

    def test_intra_needs_the_sharded_backend(self, monkeypatch):
        """``intra > 1`` runs each block's sweeps on the sharded backend
        (an ``intra``-shard sub-mesh); what that backend cannot take is
        rejected with the JAX package's errors."""
        op, b = _problem(16, 16)
        with pytest.raises(ValueError, match="no minimization"):
            tha.host_async_solve(op, b, intra=2, minimization="local")
        with pytest.raises(ValueError, match="not divisible"):
            tha.host_async_solve(op, b, intra=3)
        real, built = tha._sharded_sweep, []

        def spy(opcfg, intra, inner, device):
            built.append(intra)
            return real(opcfg, intra, inner, device)

        monkeypatch.setattr(tha, "_sharded_sweep", spy)
        res = tha.host_async_solve(op, b, intra=2, rtol=1e-2,
                                   join_timeout_s=60)
        assert built == [2, 2] and res.converged

    def test_devices_one_per_block(self):
        op, b = _problem(8, 8)
        with pytest.raises(ValueError, match="devices"):
            tha.host_async_solve(op, b, devices=["cpu"] * 3)


class TestSyncCertifyAgainstJax:
    @pytest.mark.parametrize("start_rtol", [3e-3, 1e-3])
    def test_same_rounds_and_x(self, start_rtol):
        """From an SM iterate at ``start_rtol`` (11 rounds to the bound
        at 3e-3; at 1e-3 the iterate may already be certified)."""
        op, b = _problem()
        x0 = ms.sm(op, b, rtol=start_rtol, maxiter=2000).x
        tol = 1e-3 / np.sqrt(2) * float(torch.linalg.norm(b))
        x, cert, rounds = tha._sync_certify(op, b, x0.clone(), tol,
                                            ms.InnerConfig())
        jop = jbo.block_poisson2d(32, 32)
        jx, jcert, jrounds = jha._sync_certify(
            jop, jbo.rhs_ones(jop, jnp.float64), jnp.asarray(x0.numpy()),
            tol, JInnerConfig())
        assert (cert, rounds) == (bool(jcert), int(jrounds))
        jx = np.asarray(jx)
        np.testing.assert_allclose(x.numpy(), jx, rtol=0,
                                   atol=1e-12 * np.abs(jx).max())
