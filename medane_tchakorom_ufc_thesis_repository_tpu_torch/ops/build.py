"""Build and load the port's hand-written CUDA kernels.

The counterpart of the JAX package's ``ops/fused_pallas.mosaic_available``.
Where that probe decided whether Mosaic kernels could run, here there is
nothing to decide: a CUDA tensor always goes through its kernel, so the
first launch builds the library or raises.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``.  The libraries go to ``build/torch_kernels/`` beside the
package (the checkout's root when run from a checkout); each file name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded.  A build writes to a temporary name
(the process's and the thread's id) and renames it, so concurrent
processes and threads cannot load a half-written file; ``load`` builds
each library once per process under a lock, and ``count`` adds a launch
under a lock, so block threads (``models.host_async``) launch safely.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the double-float residual's error-free transforms need every add and
# multiply rounded on its own: no FMA contraction in that file; the 2D
# apply is rounded op by op, as its plain version is, and agrees with it
# bit for bit
EXTRA_FLAGS = {"stencil3d": (), "df_residual": ("-fmad=false",),
               "stencil2d": ("-fmad=false",), "mdot": (), "csr_mv": (),
               "bsr_mv": (), "tsqr": (), "givens": ()}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_D = ctypes.c_double
# (argtypes, restype) of every exported function, by library
SIGNATURES = {
    "stencil3d": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "stencil3d_apply_partials": ([_I64, _I64, _I64], _I64),
        "stencil3d_apply": (
            [_I, _I, _I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _D,
             _D, _D, _P], _I),
        "stencil3d_apply_stack": (
            [_I, _I, _I, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _I,
             _D, _D, _D, _P], _I),
        "stencil3d_axpy_mv_dot": (
            [_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _D, _D, _P],
            _I),
        "stencil3d_residual_restrict": (
            [_I, _P, _P, _P, _I64, _I64, _I64, _I64, _F, _F, _F, _P], _I),
        "stencil3d_jacobi_dot_partials": ([_I64, _I64, _I64, _I64], _I64),
        "stencil3d_jacobi_dot": (
            [_I, _I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _F, _F, _F,
             _P], _I),
        "stencil3d_prolong_jacobi": (
            [_I, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _F, _F, _F, _P], _I),
        "stencil3d_chebyshev": (
            [_I, _P, _P, _I64, _I64, _I64, _I64, _D, _D, _P, _I, _P], _I),
    },
    "df_residual": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "stencil3d_df_residual": (
            [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _F, _F, _F, _I, _F,
             _F, _F, _P], _I),
    },
    "stencil2d": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "stencil2d_apply": ([_I, _P, _P, _I64, _I64, _I64, _D, _D, _P], _I),
        "stencil2d_mv_norm_partials": ([_I64, _I64], _I64),
        "stencil2d_mv_norm": (
            [_I, _P, _P, _P, _P, _P, _I64, _I64, _D, _D, _P], _I),
        "stencil2d_chebyshev": (
            [_I, _P, _P, _I64, _I64, _I64, _D, _D, _P, _I, _P], _I),
    },
    "mdot": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "mdot_partials_count": ([_I64, _I64, _I64], _I64),
        "mdot": ([_I, _I, _P, _P, _P, _P] + [_I64] * 6 + [_P], _I),
        "maxpy": ([_I, _I, _P, _P, _P, _P] + [_I64] * 6 + [_P], _I),
    },
    "csr_mv": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "csr_mv": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                    _I64, _P], _I),
    },
    "bsr_mv": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "bsr_mv": ([_I, _P, _P, _P, _P, _I64, _I64, _I, _I64, _I64, _I64, _P],
                   _I),
    },
    "tsqr": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "tsqr_partials_count": ([_I, _I64, _I64, _I], _I64),
        "tsqr_lstsq": ([_I, _P, _P, _P, _P, _I64, _I64, _I] + [_I64] * 5 + [_P],
                       _I),
    },
    "givens": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "givens_step": ([_I] + [_P] * 11 + [_I64] * 4 + [_P], _I),
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries
    a hash of the source bytes, of every shared header ``csrc/*.cuh`` and
    of the compiler flags."""
    flags = NVCC_FLAGS + EXTRA_FLAGS[name]
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path) -> None:
    nvcc = nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    logger.info("building %s with %s (torch %s, CUDA %s)", out.name,
                version.splitlines()[-1], torch.__version__, torch.version.cuda)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS[name], "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {name}.cu:\n{proc.stderr}")
    logger.info("%s", proc.stderr.strip())   # ptxas: registers, spills
    os.replace(tmp, out)


_libs: dict = {}
_load_lock = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use (once per
    process, whichever thread asks first)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                _compile(name, path)
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return _libs[name]


def load_all() -> None:
    """Build every missing kernel library, one ``nvcc`` per source, all
    started together, then load them all."""
    missing = [n for n in SIGNATURES if not library_path(n).exists()]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(missing))) as pool:
        for f in [pool.submit(_compile, n, library_path(n)) for n in missing]:
            f.result()
    for name in SIGNATURES:
        load(name)


def on_cuda(x: torch.Tensor) -> bool:
    """True for a tensor on the current CUDA device, False for a CPU
    tensor; raises for any other device."""
    if x.device.type == "cuda":
        if x.device.index != torch.cuda.current_device():
            raise ValueError(
                f"tensor on {x.device} but the current device is "
                f"cuda:{torch.cuda.current_device()}")
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for tensors on {x.device}")


def stream(x: torch.Tensor) -> int:
    """The handle of the current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


# Launches of every kernel wrapper of the port, by wrapper (and kind):
# each adds one with ``count`` where it launches its kernel; plain calls
# count nothing.  ``_count_lock`` guards every change.
launches: collections.Counter = collections.Counter()
_count_lock = threading.Lock()


def count(name: str) -> None:
    """Add one launch of ``name`` (thread-safe: ``+=`` on a Counter is a
    read-modify-write that loses counts between threads)."""
    with _count_lock:
        launches[name] += 1


def launch_counts() -> dict:
    """Kernel launches since the last reset, by wrapper (and kind)."""
    with _count_lock:
        return dict(launches)


def reset_launch_counts() -> None:
    with _count_lock:
        launches.clear()


class CountedGraph:
    """A CUDA graph of wrapper calls that keeps ``launches`` true.

    A capture runs no kernel, yet each wrapper called inside it adds its
    one launch.  ``capture`` takes those additions back out and keeps
    them; every ``replay`` adds them again, once for each kernel the
    replay launches.  ``graph`` is a ``torch.cuda.CUDAGraph`` (anything
    with ``replay()``), ``context`` a function returning the context
    manager that captures into it (``GraphRunner._new_graph`` makes
    both)."""

    def __init__(self, graph, context):
        self.graph, self.context = graph, context
        self.launches: collections.Counter = collections.Counter()

    def capture(self, fn):
        """Capture ``fn()`` and return its result."""
        with _count_lock:
            before = collections.Counter(launches)
        with self.context():
            out = fn()
        with _count_lock:
            self.launches = launches - before
            launches.subtract(self.launches)
            for name in [n for n, c in launches.items() if c == 0]:
                del launches[name]
        return out

    def replay(self) -> None:
        self.graph.replay()
        with _count_lock:
            launches.update(self.launches)


def _graphs_on(device) -> bool:
    """Whether steps on ``device`` replay CUDA graphs: on a card."""
    return torch.device(device).type == "cuda"


class GraphRunner:
    """``runner(name, step)``: the named steps of one owner, each a
    function of the owner's static buffers that reads nothing on the host,
    run eagerly on the CPU and as a CUDA graph each on the card.

    On the card a step's first call runs it eagerly on the caller's
    stream, as the warm-up, and does that call's work (a side stream would
    hold a cuBLAS workspace of its own, 32 MiB on the H100, at the step's
    peak).  Its second call captures it (``CountedGraph``: every replay
    counts its kernels' launches) into the runner's one memory pool and
    replays it, as does every call after.  The capture's stream takes a
    cuBLAS workspace of its own, so the workspaces other streams hold are
    freed first; a stream whose workspace went takes a new one at its next
    cuBLAS call.  So a graphed step holds no more memory than an eager one.

    Spans: ``<prefix>.replay`` around each replay and each eager call on
    the CPU, device-timed on ``on``; ``<prefix>.capture`` around each
    capture, whose seconds ``capture_s`` sums."""

    def __init__(self, prefix: str, on: torch.Tensor):
        self.replay_span = prefix + ".replay"
        self.capture_span = prefix + ".capture"
        self.on = on
        self.graphs: dict = {}
        self.warm: set = set()
        self.pool = None
        self.capture_s = 0.0

    def __call__(self, name: str, step) -> None:
        g = self.graphs.get(name)
        if g is None and name in self.warm:
            with span(self.capture_span):
                t0 = time.perf_counter()
                g = CountedGraph(*self._new_graph(step))
                g.capture(step)
                self.graphs[name] = g
                self.capture_s += time.perf_counter() - t0
        if g is not None:
            with span(self.replay_span, self.on):
                g.replay()
        elif _graphs_on(self.on.device):
            step()                               # the warm-up
            self.warm.add(name)
        else:
            with span(self.replay_span, self.on):
                step()

    def _new_graph(self, step):
        """``(graph, context)``, ``CountedGraph``'s arguments: a new CUDA
        graph and the function returning the context that captures into
        it.  ``step`` is what the capture will hold."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph, pool = torch.cuda.CUDAGraph(), self.pool

        # refers to no ``self``: no cycle keeps an owner's buffers alive
        # until the garbage collector runs
        def context():
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()
            return torch.cuda.graph(graph, pool=pool)

        return graph, context


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
