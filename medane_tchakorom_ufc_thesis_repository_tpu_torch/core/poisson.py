"""Poisson problem generators (port of the JAX package's
``core/poisson.py``): the matrix-free 2D and 3D operators and strips, the
COO and dense builders the tests hold the operators against, the ELL and
DIA packs of an assembled matrix, and the block split of an assembled
matrix into stacked ``(A_ii, A_ic)`` ELL planes.  Assembly is host-side
numpy; a pack lands on ``device`` (None: the current CUDA device)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    DIA,
    ELL,
    Stencil2D,
    Stencil3D,
    StencilStrip2D,
    StencilStrip3D,
)


def poisson2d(m: int, n: int) -> Stencil2D:
    return Stencil2D(m=m, n=n)


def poisson3d(nx: int, ny: int, nz: int) -> Stencil3D:
    return Stencil3D(nx=nx, ny=ny, nz=nz)


def strip2d(m: int, n: int, nblocks: int = 2) -> StencilStrip2D:
    """One block's row strip of the ``m x n`` 2D operator."""
    if m % nblocks:
        raise ValueError(f"m={m} not divisible by nblocks={nblocks}")
    return StencilStrip2D(rows=m // nblocks, n=n)


def strip3d(nx: int, ny: int, nz: int, nblocks: int = 2) -> StencilStrip3D:
    """One block's strip of the 3D operator, split on the x axis."""
    if nx % nblocks:
        raise ValueError(f"nx={nx} not divisible by nblocks={nblocks}")
    return StencilStrip3D(rows=nx // nblocks, ny=ny, nz=nz)


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


def block_split_ell(rows, cols, vals, shape, nblocks: int = 2,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> Tuple[ELL, ELL]:
    """Split a COO matrix into stacked per-block ``(A_ii, A_ic)`` ELL
    planes (``divideSubDomainIntoBlockMatrices``, reference
    ``src/utils/utils.c:450-478``): block ``i`` owns rows ``[i bs, (i+1)
    bs)``; ``A_ii`` keeps the columns inside the block, re-indexed
    locally, ``A_ic`` every other column with its global id.  Padded slots
    hold index 0 and value 0.

    Returns two ``ELL`` whose planes have a leading ``nblocks`` axis:
    ``A_ii`` indices ``(nblocks, bs, w1)`` with ``ncols = bs``, ``A_ic``
    indices ``(nblocks, bs, w2)`` with ``ncols = N``; the planes are built
    in numpy (the JAX package's planes, bit for bit) and land on
    ``device``."""
    nrows, ncols_g = shape
    if nrows % nblocks:
        raise ValueError("rows not divisible by nblocks")
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    bs = nrows // nblocks
    diag, off = [], []
    for blk in range(nblocks):
        lo, hi = blk * bs, (blk + 1) * bs
        rmask = (rows >= lo) & (rows < hi)
        r, c, v = rows[rmask] - lo, cols[rmask], vals[rmask]
        own = (c >= lo) & (c < hi)
        diag.append(coo_like_to_padded(r[own], c[own] - lo, v[own], bs))
        off.append(coo_like_to_padded(r[~own], c[~own], v[~own], bs))
    device = resolve(device)

    def stacked(parts, ncols):
        w = max(p[0].shape[1] for p in parts)
        idx = np.stack([_pad_w(p[0], w) for p in parts])
        val = np.stack([_pad_w(p[1], w) for p in parts])
        return ELL(indices=torch.from_numpy(idx).to(device),
                   values=torch.from_numpy(val).to(device=device,
                                                   dtype=dtype),
                   ncols=int(ncols))

    return stacked(diag, bs), stacked(off, ncols_g)


def coo_like_to_padded(r, c, v, nrows: int):
    """COO triplets -> ``(indices, values)`` padded numpy planes of
    ``nrows`` rows, entries of a row in column order (stable: duplicates
    keep their input order), width at least 1."""
    r, c, v = np.asarray(r), np.asarray(c), np.asarray(v)
    dr, dc = np.diff(r), np.diff(c)
    if not np.all((dr > 0) | ((dr == 0) & (dc >= 0))):
        # already in (row, column) order, as a CSR's triplets are, the
        # stable sort would return them as they are
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
    counts = np.bincount(r, minlength=nrows)
    w = max(int(counts.max()) if len(r) else 0, 1)
    slot = np.arange(len(r)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    indices = np.zeros((nrows, w), np.int32)
    values = np.zeros((nrows, w))
    indices[r, slot] = c
    values[r, slot] = v
    return indices, values


def _pad_w(a: np.ndarray, w: int) -> np.ndarray:
    """``a`` with zero columns appended up to width ``w``."""
    if a.shape[1] == w:
        return a
    pad = np.zeros((a.shape[0], w - a.shape[1]), a.dtype)
    return np.concatenate([a, pad], axis=1)


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
