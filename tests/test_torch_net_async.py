"""Port parity for the multi-process asynchronous multisplitting over TCP
(``models/net_async.py``), on the CPU in f64.

Two ranks run in two threads of this process over the port's TCP
transports, as the JAX package's ``tests/test_wan.py`` and
``tests/test_slcv.py`` run theirs:

* the bulk-synchronous schedule is deterministic: its rounds must equal
  those of JAX's ``net_async_block_solve`` run the same way, and one
  round of the port maps the iterate JAX's round starts from to JAX's
  result to 1e-14.  The free-running iterates of the two packages agree
  to 1e-5 only: a round of GMRES(30), 20 steps at inner rtol 1e-3,
  amplifies a one-ulp difference in its input by 10-20x in the first
  rounds (measured: 1e-16 after one round, 3e-9 after 49 rounds at
  16², rtol 1e-5);
* ``protocol`` (Alg-5.15 with the certification tail), ``slcv`` and
  ``traversal`` must terminate, certified or within the slack of JAX's
  tests; AMAM_GLOBAL piggybacks the Gram panel on the DATA frames.

Then two OS processes through ``launch_net_async(device='cpu')`` on the
native router, as JAX's ``test_two_process_am_native``; 3, 4 and 8
processes run under the ``slow`` mark, as in JAX.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops as jbo
from medane_tchakorom_ufc_thesis_repository_tpu.models import net as jnet
from medane_tchakorom_ufc_thesis_repository_tpu.models import net_async as jna
from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
    InnerConfig as JInnerConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov as jkrylov
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import blockops
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    host_async as tha,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import net as tnet
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    net_async as tna,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (  # noqa: E501
    InnerConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.multihost import (
    free_port,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)


def _problem(m, port=True):
    if port:
        op = blockops.block_poisson2d(m, m, nblocks=2)
        return op, blockops.rhs_ones(op, torch.float64, "cpu")
    op = jbo.block_poisson2d(m, m, nblocks=2)
    return op, jbo.rhs_ones(op, jnp.float64)


def _run_threads(m, rtol, port=True, transport=None, **kw):
    """Both ranks of a 2-block solve in two threads over TCP; returns the
    ranks' results and the merged x's relative residual."""
    op, b = _problem(m, port)
    cls = transport or (tnet.TcpTransport if port else jnet.TcpTransport)
    solve = tna.net_async_block_solve if port else jna.net_async_block_solve
    inner = InnerConfig(maxiter=20) if port else JInnerConfig(maxiter=20)
    addrs = [("localhost", free_port()), ("localhost", free_port())]
    tr = [cls(r, addrs) for r in range(2)]
    out = [None, None]

    def work(r):
        out[r] = solve(op, b, r, tr[r], rtol=rtol, maxiter=3000, inner=inner,
                       s=4, **kw)

    th = [threading.Thread(target=work, args=(r,)) for r in range(2)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=240)
    for t in tr:
        t.close()
    assert out[0] is not None and out[1] is not None
    x = np.concatenate([np.asarray(out[r]["x_block"]) for r in range(2)])
    bn = np.asarray(b).reshape(-1)
    ax = (op.global_mv(torch.from_numpy(x)).numpy() if port
          else np.asarray(op.global_mv(jnp.asarray(x))))
    return out, x, np.linalg.norm(bn - ax) / out[0]["rnorm0"]


class TestSyncSchedule:
    @pytest.mark.parametrize("minimization", [None, "global"])
    def test_rounds_equal_jax(self, minimization):
        out, x, rel = _run_threads(16, 1e-5, schedule="sync",
                                   minimization=minimization)
        jout, jx, _ = _run_threads(16, 1e-5, port=False, schedule="sync",
                                   minimization=minimization)
        assert all(o["converged"] and o["certified"] for o in out)
        assert ([o["sweeps"] for o in out] == [o["sweeps"] for o in jout])
        assert out[0]["sweeps"] == out[1]["sweeps"]     # lockstep
        assert rel <= 1.3e-5, rel
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-5 * np.abs(jx).max())

    def test_one_round_equals_jax(self):
        """The sync round (each block's rhs from the other's iterate, one
        inner GMRES a block) from the iterate JAX's round starts from."""
        m = 16
        op, b = _problem(m)
        jop, jb = _problem(m, port=False)
        sweeps = [tha._gmres_sweep(tha._block_mv(op, k), InnerConfig())
                  for k in range(2)]

        @jax.jit
        def jround(xs):
            rhs = jb - jop.coupling_mv(xs)
            return jnp.stack([
                jkrylov.gmres(lambda v: jop.single_diag_mv(None, v), rhs[k],
                              xs[k], restart=30, maxiter=20, rtol=1e-3,
                              atol=0.0, orthog="cgs2").x for k in range(2)])

        x = np.zeros((2, m * m // 2))
        for _ in range(12):
            jx = np.asarray(jround(jnp.asarray(x)))
            xs = torch.from_numpy(x)
            rhs = b - op.coupling_mv(xs)
            tx = torch.stack([sweeps[k](rhs[k], xs[k])[0]
                              for k in range(2)]).numpy()
            np.testing.assert_allclose(tx, jx, rtol=0,
                                       atol=1e-14 * np.abs(jx).max())
            x = np.array(jx)


class TestAsyncTermination:
    def test_protocol_certified(self):
        out, _, rel = _run_threads(12, 1e-4, termination="protocol")
        assert all(o["converged"] and o["certified"] for o in out)
        assert all(o["tail_rounds"] >= 0 and o["sweeps"] > 0 for o in out)
        assert rel <= 1e-4, rel

    @pytest.mark.parametrize("termination,slack", [("slcv", 30),
                                                   ("traversal", 200)])
    def test_legacy_guards(self, termination, slack):
        # no certificate: the async slack of JAX's tests
        out, _, rel = _run_threads(12, 1e-4, termination=termination)
        assert all(o["converged"] and o["certified"] is None for o in out)
        assert rel <= slack * 1e-4, rel

    def test_amam_global_native_router(self):
        out, _, rel = _run_threads(12, 1e-4, minimization="global",
                                   transport=tnet.NativeTcpTransport)
        assert all(o["converged"] for o in out)
        if all(o["certified"] for o in out):
            assert rel <= 1e-4, rel
        else:
            assert rel <= 50 * 1e-4, rel

    def test_minimization_rejects_traversal(self):
        with pytest.raises(ValueError, match="protocol"):
            tna.net_async_block_solve(None, None, 0, None,
                                      termination="traversal",
                                      minimization="global")

    def test_worker_asked_for_the_card_raises_without_one(self):
        assert not torch.cuda.is_available()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tna.worker_main(["--rank", "0", "--ports", "1,2",
                             "--device", "cuda"])


def _merged_rel(results, m, n, nblocks):
    op = blockops.block_poisson2d(m, n, nblocks=nblocks)
    b = blockops.rhs_ones(op, torch.float64, "cpu")
    x = torch.from_numpy(np.stack([
        np.asarray(r["x_block"])
        for r in sorted(results, key=lambda r: r["rank"])]))
    r = b - op.full_mv(x)
    return float(torch.linalg.norm(r) / torch.linalg.norm(b))


def _check(results, rtol, m, n, nblocks):
    assert len(results) == nblocks
    assert all(r["converged"] for r in results)
    assert max(r["phase_tag"] for r in results) >= 1
    rel = _merged_rel(results, m, n, nblocks)
    if all(r["certified"] for r in results):
        assert rel <= rtol
    else:
        assert rel <= 50 * rtol


class TestProcesses:
    def test_two_process_am_native(self):
        res = tna.launch_net_async(nblocks=2, m=32, n=32, rtol=1e-4,
                                   maxiter=4000, transport="native",
                                   timeout_s=240, device="cpu")
        _check(res, 1e-4, 32, 32, 2)
        assert all(r["sweeps"] > 0 and r["elapsed_s"] > 0 for r in res)

    @pytest.mark.slow
    def test_three_blocks_python_router(self):
        res = tna.launch_net_async(nblocks=3, m=33, n=33, rtol=1e-4,
                                   maxiter=4000, transport="python",
                                   timeout_s=240, device="cpu")
        _check(res, 1e-4, 33, 33, 3)

    @pytest.mark.slow
    def test_four_blocks_native_router(self):
        res = tna.launch_net_async(nblocks=4, m=44, n=44, rtol=1e-4,
                                   maxiter=6000, transport="native",
                                   timeout_s=300, device="cpu")
        _check(res, 1e-4, 44, 44, 4)

    @pytest.mark.slow
    def test_eight_blocks(self):
        res = tna.launch_net_async(nblocks=8, m=88, n=88, rtol=1e-3,
                                   maxiter=8000, timeout_s=540, device="cpu")
        _check(res, 1e-3, 88, 88, 8)
