"""Port parity for the TCP transports (``models/net.py``): the Python
``TcpTransport`` and the native router ``NativeTcpTransport``
(``native/src/comm.cpp``), on their own and against the JAX package's
``TcpTransport`` frame for frame.

The transport cases of the JAX package's ``tests/test_net_async.py`` and
``tests/test_wan.py`` run on the port's two backends.  The interop cases
pair a port endpoint with a JAX one, both ways: every protocol kind, the
latest-wins DATA mailbox and the RTT probe must cross unchanged (a
``!6i`` header and a raw payload).  Messages are compared by value:
each package has its own ``Msg`` class.
"""

import socket
import time

import numpy as np
import pytest
import torch

from medane_tchakorom_ufc_thesis_repository_tpu.models import convergence as jconv
from medane_tchakorom_ufc_thesis_repository_tpu.models import net as jnet
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import (
    convergence as tconv,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models import net as tnet
from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.multihost import (
    free_port,
)

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)

# endpoint kind -> (transport class, its package's convergence module)
KINDS = {
    "port_python": (tnet.TcpTransport, tconv),
    "port_native": (tnet.NativeTcpTransport, tconv),
    "jax_python": (jnet.TcpTransport, jconv),
}
PAIRS = [("port_python", "port_python"), ("port_native", "port_native"),
         ("port_python", "jax_python"), ("jax_python", "port_python"),
         ("port_native", "jax_python"), ("jax_python", "port_native")]


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _open(kinds, wan=None):
    addrs = [("localhost", free_port()), ("localhost", free_port())]
    return [KINDS[k][0](r, addrs, **({"wan": wan} if wan else {}))
            for r, k in enumerate(kinds)]


def _value(msg):
    return (msg.kind.value, msg.src, msg.phase_tag, msg.iteration,
            msg.positive)


@pytest.fixture(params=PAIRS, ids=["-".join(p) for p in PAIRS])
def pair(request):
    ends = _open(request.param)
    yield ends, [KINDS[k][1] for k in request.param]
    for t in ends:
        t.close()


@pytest.fixture(params=["port_python", "port_native"])
def same_pair(request):
    ends = _open([request.param] * 2)
    yield ends
    for t in ends:
        t.close()


class TestRaceMarkers:
    def test_bind_race_marker_matches_os_errno_text(self):
        port = free_port()
        srv = socket.create_server(("127.0.0.1", port), reuse_port=False)
        try:
            with pytest.raises(OSError) as ei:
                socket.create_server(("127.0.0.1", port), reuse_port=False)
            assert tnet.BIND_RACE_MARKER in str(ei.value).lower()
        finally:
            srv.close()
        assert tnet.BIND_RACE_MARKER == jnet.BIND_RACE_MARKER

    def test_stolen_port_marker_matches_checked_send(self):
        class Dummy:
            _ok_sends: set = set()
            _departed: set = set()

        with pytest.raises(OSError) as ei:
            tnet.NativeTcpTransport._checked_send(Dummy(), 1, -1, "send_data")
        assert tnet.STOLEN_PORT_MARKER in str(ei.value).lower()
        assert tnet.STOLEN_PORT_MARKER == jnet.STOLEN_PORT_MARKER


class TestFrames:
    """Port and JAX endpoints, both ways, frame for frame."""

    def test_all_kinds(self, pair):
        (t0, t1), (c0, _) = pair
        sent = [c0.Msg(kind=k, src=0, phase_tag=i, iteration=i * 3,
                       positive=bool(i % 2))
                for i, k in enumerate(c0.MsgKind)]
        for m in sent:
            t0.send(1, m)
        got = []
        assert _wait(lambda: bool(got.extend(t1.drain(1))
                                  or len(got) == len(sent)))
        assert [_value(m) for m in got] == [_value(m) for m in sent]

    def test_data_latest_wins(self, pair):
        (t0, t1), _ = pair
        for it in range(5):
            t0.send_data(1, it, np.full((8,), float(it)))
        assert _wait(lambda: t1.read_data(0, np.float64, (8,))[1] == 5)
        arr, it, ver = t1.read_data_tagged(0, np.float64, (8,))
        assert (it, ver) == (4, 5)
        np.testing.assert_array_equal(arr, np.full((8,), 4.0))

    def test_f32_payload_and_negative_tag(self, pair):
        (t0, t1), _ = pair
        x = np.arange(7, dtype=np.float32) / 3
        t0.send_data(1, -1_000_000_003, x)
        assert _wait(lambda: t1.read_data(0, np.float32, (7,))[0] is not None)
        arr, it, _ = t1.read_data_tagged(0, np.float32, (7,))
        assert it == -1_000_000_003
        np.testing.assert_array_equal(arr, x)

    def test_bidirectional_and_rtt(self, pair):
        (t0, t1), _ = pair
        t0.send_data(1, 1, np.ones((4,)))
        t1.send_data(0, 1, np.zeros((4,)))
        assert _wait(lambda: t1.read_data(0, np.float64, (4,))[0] is not None)
        assert _wait(lambda: t0.read_data(1, np.float64, (4,))[0] is not None)
        assert 0 < t0.rtt(1, timeout=5.0) < 1.0
        assert 0 < t1.rtt(0, timeout=5.0) < 1.0


class TestTransport:
    def test_departed_peer_sends_drop_silently(self, same_pair):
        t0, t1 = same_pair
        t0.send_data(1, 1, np.ones((4,)))
        assert _wait(lambda: t1.read_data(0, np.float64, (4,))[0] is not None)
        t1.close()
        for it in range(2, 12):
            t0.send_data(1, it, np.full((4,), float(it)))
            t0.send(1, tconv.Msg(kind=tconv.MsgKind.PARTIAL_CV, src=0,
                                 phase_tag=1, iteration=it, positive=True))
            time.sleep(0.01)

    def test_unreached_peer_still_raises(self):
        addrs = [("localhost", free_port()), ("localhost", free_port())]
        t0 = tnet.TcpTransport(0, addrs, connect_timeout=0.5)
        try:
            with pytest.raises(OSError):
                t0.send_data(1, 1, np.ones((4,)))
        finally:
            t0.close()

    def test_alg515_verdict_and_rebound(self, same_pair):
        t0, t1 = same_pair
        n0 = tconv.Alg515Node(0, [1], t0, persistence=1)
        n1 = tconv.Alg515Node(1, [0], t1, persistence=1)
        # the non-leader claims and retracts while the leader never holds
        # local CV: no verdict
        for i in range(20):
            n0.step(under_threshold=(i % 3 == 0), fresh_from=[1])
            n1.step(under_threshold=False, fresh_from=[0])
            time.sleep(0.002)
        assert tconv.State.FINISHED not in (n0.state, n1.state)
        deadline = time.monotonic() + 10.0
        while ((n0.state is not tconv.State.FINISHED
                or n1.state is not tconv.State.FINISHED)
               and time.monotonic() < deadline):
            n0.step(under_threshold=True, fresh_from=[1])
            n1.step(under_threshold=True, fresh_from=[0])
            time.sleep(0.002)
        assert n0.state is n1.state is tconv.State.FINISHED

    def test_factory(self, monkeypatch):
        from medane_tchakorom_ufc_thesis_repository_tpu_torch import native

        addrs = [("localhost", free_port()), ("localhost", free_port())]
        for backend, cls in (("auto", tnet.NativeTcpTransport),
                             ("native", tnet.NativeTcpTransport),
                             ("python", tnet.TcpTransport)):
            t = tnet.make_tcp_transport(0, addrs, backend=backend)
            try:
                assert type(t) is cls
            finally:
                t.close()
        with pytest.raises(ValueError, match="backend"):
            tnet.make_tcp_transport(0, addrs, backend="mpi")

        def broken():
            raise RuntimeError("g++ failed (1) on comm.cpp")

        # 'auto' never falls back to the Python router
        monkeypatch.setattr(native, "load_comm", broken)
        with pytest.raises(RuntimeError, match="comm.cpp"):
            tnet.make_tcp_transport(0, addrs, backend="auto")


class TestWan:
    @pytest.mark.parametrize("kind", ["port_python", "port_native"])
    def test_latency_shows_in_rtt_and_data(self, kind):
        a, b = _open([kind] * 2, wan=tnet.WanConfig(latency_s=0.04))
        try:
            assert 0.07 < a.rtt(1, timeout=10.0) < 0.5   # ~2 x 40 ms
            t0 = time.monotonic()
            a.send_data(1, 1, np.arange(4, dtype=np.float64))
            assert _wait(lambda: b.read_data(0, np.float64, (4,))[0]
                         is not None)
            assert 0.03 < time.monotonic() - t0 < 1.0
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("kind", ["port_python", "port_native"])
    def test_fifo_no_reorder_under_jitter(self, kind):
        a, b = _open([kind] * 2, wan=tnet.WanConfig(
            latency_s=0.002, jitter_s=0.02, seed=3))
        try:
            for it in range(20):
                a.send_data(1, it + 1, np.full(2, float(it)))
            assert _wait(lambda: b.read_data(0, np.float64, (2,))[1] >= 20)
            arr, ver = b.read_data(0, np.float64, (2,))
            assert ver == 20 and arr[0] == 19.0, (ver, arr)
        finally:
            a.close()
            b.close()

    def test_drop_applies_to_data_only(self):
        a, b = _open(["port_python"] * 2, wan=tnet.WanConfig(
            latency_s=0.001, drop=0.6, seed=1))
        try:
            for it in range(60):
                a.send_data(1, it + 1, np.full(2, float(it)))
            time.sleep(0.6)
            _, ver = b.read_data(0, np.float64, (2,))
            assert 5 < ver < 50, ver
            assert a.rtt(1, timeout=5.0) < 1.0
        finally:
            a.close()
            b.close()

    def test_bandwidth_serializes(self):
        # 80 KB at 1 Mbit/s: about 0.64 s on the link
        a, b = _open(["port_python"] * 2,
                     wan=tnet.WanConfig(bandwidth_bps=1e6))
        try:
            t0 = time.monotonic()
            a.send_data(1, 1, np.zeros(10000, np.float64))
            assert _wait(lambda: b.read_data(0, np.float64, (10000,))[0]
                         is not None)
            assert time.monotonic() - t0 > 0.4
        finally:
            a.close()
            b.close()
