"""The port's native host library (port of the JAX package's ``native``).

Two C++ sources, each built with ``g++`` at its first use and bound with
``ctypes``:

* ``src/assembly.cpp`` -- the Poisson ELL/DIA planes, the general COO to
  ELL pack and the counting-sort block-ELL pack (``bsr_pack``) that
  ``core.operators`` packs every BSR matrix with;
* ``src/comm.cpp`` -- the epoll TCP router behind
  ``models.net.NativeTcpTransport``.

The libraries go to ``build/native/`` beside the package (the checkout's
root when run from a checkout), never into the package directory.  Each
file name carries a hash of its source, its flags and, for the
``-march=native`` build, the target that ``g++`` resolves ``native`` to,
so an edited source or another CPU gets its own library.  A build writes
to a temporary name (the process's and the thread's id) and renames it.
A failed build raises: there is no numpy fallback, as ``g++`` is part of
the toolchain the port needs (``core.operators._bsr_pack_plain`` is the
tests' oracle, not a fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

FLAGS = {
    "assembly": ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
    "comm": ("-O3", "-std=c++17", "-pthread", "-shared", "-fPIC"),
}

_libs: dict = {}
_lock = threading.Lock()


def _target() -> bytes:
    """What ``-march=native`` means on this host (``g++ -Q
    --help=target``): a library built for one CPU is not loaded on
    another."""
    proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, check=True)
    return proc.stdout


def library_path(name: str) -> Path:
    """Where ``src/<name>.cpp`` is built: the name carries a hash of the
    source, the flags and (with ``-march=native``) the resolved target."""
    flags = FLAGS[name]
    h = hashlib.sha256((SRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_target())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS[name], "-o", str(tmp), str(SRC / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {name}.cpp: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) on {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)


def _load(name: str, bind) -> ctypes.CDLL:
    """The library of ``src/<name>.cpp``, built on first use (once per
    process), with ``bind(lib)`` setting its signatures."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                _compile(name, path)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[name] = lib
        return _libs[name]


def _bind_assembly(lib: ctypes.CDLL) -> None:
    i64, f64 = ctypes.c_int64, ctypes.c_double
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.poisson2d_ell.argtypes = [i64, i64, f64, f64, p_i32, p_f64]
    lib.poisson2d_ell.restype = None
    lib.poisson3d_ell.argtypes = [i64, i64, i64, f64, f64, p_i32, p_f64]
    lib.poisson3d_ell.restype = None
    lib.poisson2d_dia.argtypes = [i64, i64, f64, f64, p_f64]
    lib.poisson2d_dia.restype = None
    lib.poisson3d_dia.argtypes = [i64, i64, i64, f64, f64, p_f64]
    lib.poisson3d_dia.restype = None
    lib.coo_to_ell.argtypes = [i64, i64, i64, p_i64, p_i64, p_f64, p_i32,
                               p_f64]
    lib.coo_to_ell.restype = ctypes.c_int32
    lib.bsr_pack_plan.argtypes = [i64, i64, i64, i64, p_i64, p_i64, p_i64,
                                  p_i64, p_i32]
    lib.bsr_pack_plan.restype = i64
    lib.bsr_pack_fill.argtypes = [i64, i64, i64, i64, p_i64, p_i64, p_f64,
                                  p_i64, p_i64, p_i32, p_i32, p_f64]
    lib.bsr_pack_fill.restype = None


def _bind_comm(lib: ctypes.CDLL) -> None:
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.comm_create.argtypes = [i32, ctypes.c_char_p]
    lib.comm_create.restype = i64
    lib.comm_send.argtypes = [i64, i32, i32, i32, i32, i32, u8p, i64]
    lib.comm_send.restype = i32
    lib.comm_drain.argtypes = [
        i64, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"), i32]
    lib.comm_drain.restype = i32
    lib.comm_read_data.argtypes = [
        i64, i32, np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        i64, ctypes.POINTER(i32)]
    lib.comm_read_data.restype = i64
    lib.comm_rtt.argtypes = [i64, i32, f64]
    lib.comm_rtt.restype = f64
    lib.comm_set_wan.argtypes = [i64, f64, f64, f64, f64, i64]
    lib.comm_set_wan.restype = i32
    lib.comm_close.argtypes = [i64]
    lib.comm_close.restype = None


def load() -> ctypes.CDLL:
    """The assembly library (``src/assembly.cpp``), built on first use."""
    return _load("assembly", _bind_assembly)


def load_comm() -> ctypes.CDLL:
    """The TCP router (``src/comm.cpp``), built on first use."""
    return _load("comm", _bind_comm)


def bsr_pack(rows, cols, vals, shape, bs: int):
    """Block-ELL pack: ``(indices (nbr, width) int32, values (nbr, width,
    bs, bs) f64)``, blocks in block-column order within a block row, each
    stored transposed (``values[r, w, j, i] = A_blk[i, j]``), duplicates
    summed in input order.  An entry outside ``shape`` raises
    ``ValueError``."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    nnz = rows.shape[0]
    nrows = int(shape[0])
    nbr = -(-nrows // bs)
    order = np.empty(max(nnz, 1), np.int64)
    rowptr = np.empty(nbr + 1, np.int64)
    slot = np.empty(max(nnz, 1), np.int32)
    width = lib.bsr_pack_plan(nnz, nrows, int(shape[1]), bs, rows, cols,
                              order, rowptr, slot)
    if width < 0:
        raise ValueError(f"bsr_pack: entry outside ({shape[0]}, {shape[1]})")
    indices = np.empty((nbr, width), np.int32)
    values = np.empty((nbr, width, bs, bs), np.float64)
    lib.bsr_pack_fill(nnz, nrows, bs, width, rows, cols, vals, order, rowptr,
                      slot, indices, values)
    return indices, values


def poisson2d_ell_np(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """ELL planes (indices int32 (m*n, 5), values f64) for 2D Poisson."""
    indices = np.empty((m * n, 5), np.int32)
    values = np.empty((m * n, 5), np.float64)
    load().poisson2d_ell(m, n, diag, off, indices, values)
    return indices, values


def poisson3d_ell_np(nx: int, ny: int, nz: int, diag: float = 6.0,
                     off: float = -1.0):
    """ELL planes (indices int32 (nx*ny*nz, 7), values f64) for 3D
    Poisson."""
    size = nx * ny * nz
    indices = np.empty((size, 7), np.int32)
    values = np.empty((size, 7), np.float64)
    load().poisson3d_ell(nx, ny, nz, diag, off, indices, values)
    return indices, values


def poisson2d_dia_np(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """DIA planes (5, m*n) with offsets (-n, -1, 0, 1, n)."""
    data = np.empty((5, m * n), np.float64)
    load().poisson2d_dia(m, n, diag, off, data)
    return data, (-n, -1, 0, 1, n)


def poisson3d_dia_np(nx: int, ny: int, nz: int, diag: float = 6.0,
                     off: float = -1.0):
    """DIA planes (7, nx*ny*nz) with offsets (-ny*nz, -nz, -1, 0, 1, nz,
    ny*nz)."""
    sx = ny * nz
    data = np.empty((7, nx * ny * nz), np.float64)
    load().poisson3d_dia(nx, ny, nz, diag, off, data)
    return data, (-sx, -nz, -1, 0, 1, nz, sx)


def coo_to_ell_np(rows, cols, vals, nrows: int, width: int):
    """General COO -> ELL pack (entries lexsorted by (row, col)); a row of
    more than ``width`` entries raises ``ValueError``."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indices = np.empty((nrows, width), np.int32)
    values = np.empty((nrows, width), np.float64)
    rc = load().coo_to_ell(len(rows), nrows, width, rows, cols, vals,
                           indices, values)
    if rc != 0:
        raise ValueError(f"a row exceeds ELL width {width}")
    return indices, values
