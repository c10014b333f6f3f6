"""Poisson problem generators (port of the JAX package's
``core/poisson.py``: the matrix-free 2D and 3D operators, and the 2D COO
and dense builders the tests hold the operators against)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
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


def rhs_for_exact_ones(op: Union[Stencil2D, Stencil3D],
                       dtype: Optional[torch.dtype] = None,
                       device=None) -> torch.Tensor:
    """b = A @ ones (flat), so that the exact solution is u = 1.
    ``dtype`` defaults to torch's default float dtype."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return op.mv(torch.ones(op.shape[1], dtype=dtype, device=device))
