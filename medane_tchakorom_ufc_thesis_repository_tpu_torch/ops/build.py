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
and renames it, so concurrent processes cannot load a half-written file.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

import torch

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
               "bsr_mv": ()}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_D = ctypes.c_double
# (argtypes, restype) of every exported function, by library
SIGNATURES = {
    "stencil3d": {
        "kernel_error_string": ([_I], ctypes.c_char_p),
        "stencil3d_apply_partials": ([_I64, _I64, _I64], _I64),
        "stencil3d_apply": (
            [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _D, _D, _D,
             _P], _I),
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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS[name], "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {name}.cu:\n{proc.stderr}")
    logger.info("%s", proc.stderr.strip())   # ptxas: registers, spills
    os.replace(tmp, out)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use."""
    path = library_path(name)
    if not path.exists():
        _compile(name, path)
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


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
# each adds one where it launches its kernel; plain calls count nothing.
launches: collections.Counter = collections.Counter()


def launch_counts() -> dict:
    """Kernel launches since the last reset, by wrapper (and kind)."""
    return dict(launches)


def reset_launch_counts() -> None:
    launches.clear()


class CountedGraph:
    """A CUDA graph of wrapper calls that keeps ``launches`` true.

    A capture runs no kernel, yet each wrapper called inside it adds its
    one launch.  ``capture`` takes those additions back out and keeps
    them; every ``replay`` adds them again, once for each kernel the
    replay launches.  ``graph`` is a ``torch.cuda.CUDAGraph`` (anything
    with ``replay()``), ``context`` a function returning the context
    manager that captures into it (``torch.cuda.graph(graph, ...)``)."""

    def __init__(self, graph, context):
        self.graph, self.context = graph, context
        self.launches: collections.Counter = collections.Counter()

    def capture(self, fn):
        """Capture ``fn()`` and return its result."""
        before = collections.Counter(launches)
        with self.context():
            out = fn()
        self.launches = launches - before
        launches.subtract(self.launches)
        for name in [n for n, c in launches.items() if c == 0]:
            del launches[name]
        return out

    def replay(self) -> None:
        self.graph.replay()
        launches.update(self.launches)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
