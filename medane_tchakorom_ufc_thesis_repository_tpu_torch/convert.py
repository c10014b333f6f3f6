"""Carry state across from the JAX package.

The solvers have no weights: an operator's shape and coefficients, the
right-hand side (a double-float pair for the north-star, a stacked
``(nblocks, block_size)`` array for multisplitting), a start and a
result are the whole state.  These helpers take them from the JAX
package's objects or from numpy arrays, and give a multisplitting result
back as numpy, so that both packages work from the same numbers.
Nothing here imports JAX: a JAX operator is read by its attributes, and
arrays arrive as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    Stencil2D,
    Stencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.blockops import (
    StackedStencil2D,
    StackedStencil3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.models.multisplitting import (
    MultisplitResult,
)

# the port's operators, by the JAX class name, with the fields they take
_OPERATORS = {
    "Stencil2D": (Stencil2D, ("m", "n")),
    "Stencil3D": (Stencil3D, ("nx", "ny", "nz")),
    "StackedStencil2D": (StackedStencil2D, ("m", "n", "nblocks")),
    "StackedStencil3D": (StackedStencil3D, ("nx", "ny", "nz", "nblocks")),
}
# MultisplitResult fields that are arrays (the rest are counts and flags)
_RESULT_ARRAYS = ("x", "inner_iters", "rnorm", "rnorm0", "local_rnorms",
                  "outer_rnorm", "history")
_RESULT_FLAGS = ("converged", "certified")


def from_jax_operator(op):
    """The port's operator with the class, shape and coefficients of the
    JAX package's ``op`` (``Stencil2D``, ``Stencil3D``,
    ``StackedStencil2D`` or ``StackedStencil3D``)."""
    name = type(op).__name__
    if name not in _OPERATORS:
        raise TypeError(f"{name} is not ported; ported: {tuple(_OPERATORS)}")
    cls, dims = _OPERATORS[name]
    return cls(*(int(getattr(op, d)) for d in dims), diag=float(op.diag),
               off=float(op.off))


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


def multisplit_result_from_numpy(fields: dict, device=None) -> MultisplitResult:
    """The port's ``MultisplitResult`` from a mapping of the JAX
    ``MultisplitResult``'s fields as numpy values (a missing or None
    field stays None; ``syncs``, which JAX does not count, is 0)."""
    kw = {}
    for f in dataclasses.fields(MultisplitResult):
        v = fields.get(f.name)
        if v is None:
            continue
        if f.name in _RESULT_ARRAYS:
            kw[f.name] = tensor_from_numpy(v, device)
        elif f.name in _RESULT_FLAGS:
            kw[f.name] = bool(v)
        else:
            kw[f.name] = int(v)
    return MultisplitResult(**kw)


def multisplit_result_to_numpy(res: MultisplitResult) -> dict:
    """Every field of the port's ``MultisplitResult``: arrays as numpy
    (on the host), counts and flags as they are."""
    return {f.name: (getattr(res, f.name).cpu().numpy()
                     if isinstance(getattr(res, f.name), torch.Tensor)
                     else getattr(res, f.name))
            for f in dataclasses.fields(res)}
