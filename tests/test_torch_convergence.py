"""Port parity for the decentralized termination protocols
(``models/convergence.py``: ``Alg515Node``, ``SlcvNode``, ``slcv_tree``,
``LocalTransport``).

The scenarios of the JAX package's ``tests/test_convergence_protocol.py``
and the protocol classes of ``tests/test_slcv.py`` run again here on the
port's classes: their source is read, the JAX module name of
``convergence`` swapped for the port's, and their test classes collected
under the same names.  Then one scripted schedule (under-threshold flags
and fresh-data sets from a seed, with messages held back and delivered
late) drives JAX's and the port's nodes side by side: after every step
the nodes' states and the messages each sent must be equal.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    convergence as jconv,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    convergence as tconv,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

JAX_MOD = "medane_tchakorom_ufc_thesis_repository_tpu.models.convergence"
PORT_MOD = "medane_tchakorom_ufc_thesis_repository_tpu_torch.models.convergence"


def _on_the_port(filename: str) -> types.ModuleType:
    """The JAX test module ``filename``, importing the port's
    ``convergence`` instead of JAX's."""
    path = Path(__file__).parent / filename
    src = path.read_text()
    assert JAX_MOD in src
    mod = types.ModuleType(f"port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src.replace(JAX_MOD, PORT_MOD), str(path), "exec"),
         mod.__dict__)
    return mod


_protocol = _on_the_port("test_convergence_protocol.py")
_slcv = _on_the_port("test_slcv.py")

TestBasicTermination = _protocol.TestBasicTermination
TestPersistence = _protocol.TestPersistence
TestReboundCancellation = _protocol.TestReboundCancellation
TestStaleness = _protocol.TestStaleness
TestLeaderElection = _protocol.TestLeaderElection
TestTree = _slcv.TestTree
TestSlcvProtocol = _slcv.TestSlcvProtocol


def test_scenarios_run_on_the_port():
    assert _protocol.Alg515Node is tconv.Alg515Node
    assert _protocol.LocalTransport is tconv.LocalTransport
    assert _slcv.SlcvNode is tconv.SlcvNode
    assert _slcv.slcv_tree is tconv.slcv_tree


def test_copy_has_the_same_enums():
    assert [(k.name, k.value) for k in tconv.MsgKind] == [
        (k.name, k.value) for k in jconv.MsgKind]
    assert [(k.name, k.value) for k in tconv.State] == [
        (k.name, k.value) for k in jconv.State]


class _Recorder:
    """A transport over one package's ``LocalTransport`` that records
    every message sent and holds those to ``held`` ranks back until
    ``release``."""

    def __init__(self, conv, n):
        self.inner = conv.LocalTransport(n)
        self.sent = []
        self.held = set()
        self.pending = []

    def send(self, dst, msg):
        self.sent.append((dst, msg.kind.value, msg.src, msg.phase_tag,
                          msg.iteration, msg.positive))
        if dst in self.held:
            self.pending.append((dst, msg))
        else:
            self.inner.send(dst, msg)

    def drain(self, rank):
        return self.inner.drain(rank)

    def release(self):
        for dst, msg in self.pending:
            self.inner.send(dst, msg)
        self.pending = []

    def take(self):
        out, self.sent = self.sent, []
        return out


def _alg_state(node):
    return (node.state.value, node.phase_tag, node.local_cv,
            node.under_count, dict(node.fresh), dict(node.partial_cv),
            node.sent_partial, dict(node.responses), node.iteration)


def _slcv_state(node):
    return (node.iteration, node.under_count, node.s_local_cv,
            node.sent_partial, dict(node.child_partial), dict(node._last_s),
            dict(node._last_c), node.global_cv)


def _script(n, steps, seed):
    """Per step: (rank, under-threshold, fresh-from, ranks held back,
    release?)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        rank = int(rng.integers(0, n))
        # mostly under threshold late in the run, with rebounds
        under = bool(rng.random() < (0.3 if i < steps // 3 else 0.85))
        fresh = [int(j) for j in range(n)
                 if j != rank and rng.random() < 0.7]
        held = {int(j) for j in range(n) if rng.random() < 0.15}
        out.append((rank, under, fresh, held, bool(rng.random() < 0.3)))
    return out


@pytest.mark.parametrize("n,persistence,seed", [(2, 1, 0), (3, 2, 1),
                                                (4, 3, 2)])
def test_alg515_lockstep_with_jax(n, persistence, seed):
    nodes, recs = {}, {}
    for name, conv in (("jax", jconv), ("port", tconv)):
        rec = _Recorder(conv, n)
        recs[name] = rec
        nodes[name] = [conv.Alg515Node(r, [j for j in range(n) if j != r],
                                       rec, persistence=persistence)
                       for r in range(n)]
    finished = False
    for step, (rank, under, fresh, held, release) in enumerate(
            _script(n, 400, seed)):
        for name in nodes:
            recs[name].held = held
            nodes[name][rank].step(under_threshold=under, fresh_from=fresh)
            if release:
                recs[name].release()
                for node in nodes[name]:
                    node.pump()
        assert recs["jax"].take() == recs["port"].take(), step
        assert ([_alg_state(x) for x in nodes["jax"]]
                == [_alg_state(x) for x in nodes["port"]]), step
        finished = finished or any(
            x.state is tconv.State.FINISHED for x in nodes["port"])
    assert finished    # the script reaches a verdict


@pytest.mark.parametrize("n,threshold,seed", [(2, 2, 3), (5, 1, 4),
                                              (7, 3, 5)])
def test_slcv_lockstep_with_jax(n, threshold, seed):
    nodes, recs = {}, {}
    for name, conv in (("jax", jconv), ("port", tconv)):
        rec = _Recorder(conv, n)
        recs[name] = rec
        nodes[name] = [conv.SlcvNode(r, n, rec, threshold_slcv=threshold)
                       for r in range(n)]
    seen_global = False
    for step, (rank, under, _, held, release) in enumerate(
            _script(n, 400, seed)):
        for name in nodes:
            recs[name].held = held
            nodes[name][rank].step(under)
            if release:
                recs[name].release()
                for node in nodes[name]:
                    node.pump()
        assert recs["jax"].take() == recs["port"].take(), step
        assert ([_slcv_state(x) for x in nodes["jax"]]
                == [_slcv_state(x) for x in nodes["port"]]), step
        seen_global = seen_global or nodes["port"][0].global_cv
    assert seen_global
