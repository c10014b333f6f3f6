"""Poisson problem generators (port of the JAX package's
``core/poisson.py``): the matrix-free 2D and 3D operators, the COO and
dense builders the tests hold the operators against, and the ELL and DIA
packs of an assembled matrix.  Assembly is host-side numpy; a pack lands
on ``device`` (None: the current CUDA device)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    DIA,
    ELL,
    Stencil2D,
    Stencil3D,
)


def poisson2d(m: int, n: int) -> Stencil2D:
    return Stencil2D(m=m, n=n)


def poisson3d(nx: int, ny: int, nz: int) -> Stencil3D:
    return Stencil3D(nx=nx, ny=ny, nz=nz)


def poisson2d_coo(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """Full 2D 5-point matrix in COO ``(rows, cols, vals, shape)`` numpy
    arrays; unknown order ``i*n + j``."""
    size = m * n
    ii = np.arange(size)
    gi, gj = ii // n, ii % n
    rows = [ii]
    cols = [ii]
    vals = [np.full(size, diag)]
    for mask, delta in ((gi > 0, -n), (gi < m - 1, n), (gj > 0, -1),
                        (gj < n - 1, 1)):
        rows.append(ii[mask])
        cols.append(ii[mask] + delta)
        vals.append(np.full(mask.sum(), off))
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            (size, size))


def poisson2d_dense_np(m: int, n: int, diag: float = 4.0,
                       off: float = -1.0) -> np.ndarray:
    rows, cols, vals, shape = poisson2d_coo(m, n, diag, off)
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    return dense


def poisson3d_coo(nx: int, ny: int, nz: int, diag: float = 6.0,
                  off: float = -1.0):
    """Full 3D 7-point matrix in COO; unknown order
    ``ix*ny*nz + iy*nz + iz``."""
    size = nx * ny * nz
    ii = np.arange(size)
    ix, iy, iz = ii // (ny * nz), (ii // nz) % ny, ii % nz
    rows = [ii]
    cols = [ii]
    vals = [np.full(size, diag)]
    for mask, delta in ((ix > 0, -ny * nz), (ix < nx - 1, ny * nz),
                        (iy > 0, -nz), (iy < ny - 1, nz), (iz > 0, -1),
                        (iz < nz - 1, 1)):
        rows.append(ii[mask])
        cols.append(ii[mask] + delta)
        vals.append(np.full(mask.sum(), off))
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            (size, size))


def poisson3d_dense_np(nx: int, ny: int, nz: int, diag: float = 6.0,
                       off: float = -1.0) -> np.ndarray:
    rows, cols, vals, shape = poisson3d_coo(nx, ny, nz, diag, off)
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    return dense


def coo_to_ell(rows, cols, vals, shape, width: Optional[int] = None,
               dtype: torch.dtype = torch.float32, device=None) -> ELL:
    """Pack COO into ELLPACK planes; within a row, entries are ordered by
    column index (stable)."""
    nrows, ncols = shape
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=nrows)
    w = int(counts.max()) if width is None else width
    if counts.max() > w:
        raise ValueError(f"row with {counts.max()} nnz exceeds width {w}")
    slot = np.arange(len(rows)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    indices = np.zeros((nrows, w), np.int32)
    values = np.zeros((nrows, w))
    indices[rows, slot] = cols
    values[rows, slot] = vals
    device = resolve(device)
    return ELL(indices=torch.from_numpy(indices).to(device),
               values=torch.from_numpy(values).to(device=device, dtype=dtype),
               ncols=int(ncols))


def coo_to_dia(rows, cols, vals, shape, dtype: torch.dtype = torch.float32,
               device=None) -> DIA:
    """Pack COO into DIA planes (row-aligned diagonals)."""
    n, ncols = shape
    if n != ncols:
        raise ValueError("DIA requires a square matrix")
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    offs = cols - rows
    uniq = np.unique(offs)
    data = np.zeros((len(uniq), n))
    for d, off in enumerate(uniq):
        mask = offs == off
        data[d, rows[mask]] = vals[mask]
    return DIA(data=torch.from_numpy(data).to(device=resolve(device),
                                              dtype=dtype),
               offsets=tuple(int(o) for o in uniq))


def poisson2d_ell(m, n, dtype=torch.float32, device=None) -> ELL:
    return coo_to_ell(*poisson2d_coo(m, n), dtype=dtype, device=device)


def poisson2d_dia(m, n, dtype=torch.float32, device=None) -> DIA:
    return coo_to_dia(*poisson2d_coo(m, n), dtype=dtype, device=device)


def poisson3d_ell(nx, ny, nz, dtype=torch.float32, device=None) -> ELL:
    return coo_to_ell(*poisson3d_coo(nx, ny, nz), dtype=dtype, device=device)


def poisson3d_dia(nx, ny, nz, dtype=torch.float32, device=None) -> DIA:
    return coo_to_dia(*poisson3d_coo(nx, ny, nz), dtype=dtype, device=device)


def rhs_for_exact_ones(op,
                       dtype: Optional[torch.dtype] = None,
                       device=None) -> torch.Tensor:
    """b = A @ ones (flat), so that the exact solution is u = 1.
    ``dtype`` defaults to torch's default float dtype, ``device`` to
    the current CUDA device."""
    if dtype is None:
        dtype = getattr(op, "dtype", None) or torch.get_default_dtype()
    return op.mv(torch.ones(op.shape[1], dtype=dtype,
                            device=resolve(device)))
