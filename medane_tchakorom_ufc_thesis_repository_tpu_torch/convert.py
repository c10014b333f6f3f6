"""Carry state across from the JAX package.

The north-star has no weights: the operator's coefficients and the
double-float pair of b (or x) are the whole state.  These helpers take
them from the JAX package's objects or from numpy arrays, so that both
packages start from the same numbers.  Nothing here imports JAX: a JAX
operator is read by its attributes, and arrays arrive as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import Stencil3D


def from_jax_operator(op) -> Stencil3D:
    """The port's ``Stencil3D`` with the shape and coefficients of the
    JAX package's ``Stencil3D`` ``op``."""
    if type(op).__name__ != "Stencil3D":
        raise TypeError(f"only Stencil3D is ported, got {type(op).__name__}")
    return Stencil3D(int(op.nx), int(op.ny), int(op.nz), float(op.diag),
                     float(op.off))


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A contiguous tensor on ``device`` holding ``a``'s values and dtype
    (bf16 arrays, which numpy knows only through ``ml_dtypes``, arrive
    exactly through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")   # torch shares only writable memory
    return torch.from_numpy(a).to(device)


def df_pair_from_numpy(hi, lo, device=None):
    """A double-float (hi, lo) pair of f32 tensors on ``device``."""
    hi, lo = np.asarray(hi), np.asarray(lo)
    if hi.dtype != np.float32 or lo.dtype != np.float32:
        raise ValueError(f"df components must be f32, got {hi.dtype}, {lo.dtype}")
    return tensor_from_numpy(hi, device), tensor_from_numpy(lo, device)
