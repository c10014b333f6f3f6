"""3D Poisson problem generators (port of the JAX package's
``core/poisson.py``, 3D matrix-free part)."""

from __future__ import annotations

from typing import Optional

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import Stencil3D


def poisson3d(nx: int, ny: int, nz: int) -> Stencil3D:
    return Stencil3D(nx=nx, ny=ny, nz=nz)


def rhs_for_exact_ones(op: Stencil3D, dtype: Optional[torch.dtype] = None,
                       device=None) -> torch.Tensor:
    """b = A @ ones (flat), so that the exact solution is u = 1.
    ``dtype`` defaults to torch's default float dtype."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return op.mv(torch.ones(op.shape[1], dtype=dtype, device=device))
