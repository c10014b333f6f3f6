"""The kernel build and launch counts under threads (``ops/build.py``).

``models.host_async`` launches kernels from one thread a block, so the
first launches of two threads must build a library once, two builds may
not write one temporary file, and no launch count may be lost.  On the
CPU no wrapper launches a kernel; the counts are driven through
``build.count``, the one call every wrapper makes where it launches.
"""

import threading
from pathlib import Path

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

# one intra-op thread a process (see test_torch_stacked.py)
torch.set_num_threads(1)


def _in_threads(fn, n=8):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


class TestThreads:
    def test_no_count_is_lost(self):
        build.reset_launch_counts()
        names = ["stencil2d_apply[mv]", "mdot", "maxpy"]

        def launch(i):
            for k in range(3000):
                build.count(names[(i + k) % 3])

        _in_threads(launch)
        counts = build.launch_counts()
        assert sum(counts.values()) == 8 * 3000
        assert counts == {n: 8000 for n in names}
        build.reset_launch_counts()

    def test_load_builds_once(self, monkeypatch, tmp_path):
        built = []

        class Lib:
            def __getattr__(self, name):
                fn = type("Fn", (), {})()
                setattr(self, name, fn)
                return fn

        def fake_compile(name, out):
            built.append(name)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(b"")

        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(build, "_compile", fake_compile)
        monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
        monkeypatch.setattr(build, "_libs", {})
        libs = []
        _in_threads(lambda i: libs.append(build.load("mdot")))
        assert built == ["mdot"]
        assert len(libs) == 8 and all(lib is libs[0] for lib in libs)

    def test_temporary_names_differ_by_thread(self, monkeypatch, tmp_path):
        """Two threads building one library at once write two temporary
        files (the barrier holds both builds in flight: a thread's id is
        reused once it has ended)."""
        seen = []
        both = threading.Barrier(2, timeout=10)

        def fake_run(cmd, **kw):
            if "-o" in cmd:
                out = Path(cmd[cmd.index("-o") + 1])
                seen.append(out.name)
                out.write_bytes(b"")
                both.wait()
            return type("P", (), {"returncode": 0, "stderr": "",
                                  "stdout": "nvcc 0.0"})()

        monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
        monkeypatch.setattr(build.subprocess, "run", fake_run)
        out = tmp_path / "libmdot-test.so"
        _in_threads(lambda i: build._compile("mdot", out), n=2)
        tmps = [s for s in seen if s.endswith(".tmp")]
        assert len(tmps) == 2 and tmps[0] != tmps[1]
        assert out.exists()

    def test_counted_graph_keeps_counts_under_the_lock(self):
        class Graph:
            def replay(self):
                pass

        import contextlib

        build.reset_launch_counts()
        g = build.CountedGraph(Graph(), contextlib.nullcontext)
        g.capture(lambda: build.count("mdot"))
        assert build.launch_counts() == {}
        _in_threads(lambda i: [g.replay() for _ in range(500)])
        assert build.launch_counts() == {"mdot": 4000}
        build.reset_launch_counts()
