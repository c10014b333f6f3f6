"""Kernel M, the multigrid cycle's coarse Chebyshev solve in one launch:
wrapper, plain version, launch counts.

The coarsest level of every V or W cycle takes ``coarse_iters`` Chebyshev
steps from the zero guess (``solvers/multigrid.vcycle``).  As a loop of
PyTorch operations that is about six launches a step, 240 a visit and
~170,000 a 512^3 north-star solve.  Kernel M (``csrc/stencil3d.cu`` and
``csrc/stencil2d.cu``, device code in ``csrc/chebyshev_coarse.cuh``) runs
all the steps of one grid in one launch, and a stack of 2D grids (the
strips of inner ``pc='mg'``) as a batch.  A grid of at most 64 points
with fewer than 32 a row or plane (the coarsest grids of the north-stars
and of the 2D strips) takes one warp, whose lanes exchange d by shuffles
with no block barrier; any other grid takes one thread block.  The
launcher chooses the path from the grid's shape.  It replaces no Pallas
kernel: in the JAX package the loop is ``chebyshev``'s ``lax.fori_loop``,
compiled by XLA inside ``_df_fused_program``.

The plain version is that loop, ``chebyshev_steps`` with the operator's
apply (kernel A or E on the card, their plain versions on the CPU) as
the matvec, and without the norms the cycle never reads.  Kernel M gives
its bits: every operation rounds on its own to the storage type as the
separate PyTorch kernels round it, and the apply is the stencil
expression of kernels A and E.  The Chebyshev scalars are the host-rounded
ones of ``solvers/chebyshev.chebyshev_coefficients``, passed by value.

A grid of at most ``MAX_POINTS`` points and at most ``MAX_STEPS`` steps
fits (``fits``); ``vcycle`` keeps the loop for a larger coarsest grid,
which an odd dimension leaves behind.  The wrapper takes its plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  Each launch adds one to
``launch_counts()["stencil3d_chebyshev"]`` or ``["stencil2d_chebyshev"]``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil2d import (
    stencil2d_apply,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d import (
    stencil3d_apply,
)

MAX_POINTS = 4096    # points of one grid: its d in shared memory
MAX_STEPS = 128      # the coefficients ride the launch's parameters

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

# (theta, ((c1, c2), ...)): the Chebyshev scalars, each a float exact in
# the solve's dtype (``solvers/chebyshev.chebyshev_coefficients``)
Coefficients = Tuple[float, Tuple[Tuple[float, float], ...]]


def fits(dims: Sequence[int], steps: int) -> bool:
    """Whether kernel M takes a grid of ``dims`` (2D or 3D) and ``steps``
    Chebyshev steps."""
    return len(dims) in (2, 3) and math.prod(dims) <= MAX_POINTS \
        and steps <= MAX_STEPS


def chebyshev_steps(matvec: Callable, x: torch.Tensor, r: torch.Tensor,
                    coefs: Coefficients):
    """The Chebyshev recurrence from ``(x, r)`` with the scalars
    ``coefs``: ``d = r / theta``, then per step ``x += d``,
    ``r -= A d``, ``d = c1 d + c2 r``.  Returns ``(x, r)``."""
    theta, steps = coefs
    d = r / theta
    for c1, c2 in steps:
        x = x + d
        r = r - matvec(d)
        d = c1 * d + c2 * r
    return x, r


def _apply(dims: Tuple[int, ...], diag: float, off: float) -> Callable:
    """The operator's apply (``Stencil2D.mv`` / ``Stencil3D.mv``): kernel A
    or E on the card, their plain versions on the CPU."""
    if len(dims) == 2:
        return lambda d: stencil2d_apply(d.reshape(-1, *dims), diag=diag,
                                         off=off).reshape(d.shape)
    return lambda d: stencil3d_apply(d, kind="mv", diag=diag, off=off)


def _check(b: torch.Tensor, dims: Tuple[int, ...]) -> None:
    """A 2D grid or stack of 2D grids (the strips under ``pc='mg'``), or
    one 3D grid (a 3D cycle runs one grid at a time)."""
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"dims must be a 2D or 3D grid shape, got {dims}")
    nd = len(dims)
    if (b.dim() < nd or tuple(b.shape[b.dim() - nd:]) != dims
            or (nd == 3 and b.dim() != 3)):
        raise ValueError(f"b of shape {tuple(b.shape)} is not a grid of shape "
                         f"{dims}{' or a stack of them' if nd == 2 else ''}")
    if b.dtype not in _DTYPE_CODE:
        raise ValueError(f"chebyshev_coarse takes {tuple(_DTYPE_CODE)}, got "
                         f"{b.dtype}")


def chebyshev_coarse_plain(b: torch.Tensor, *, dims: Sequence[int],
                           diag: float, off: float,
                           coefs: Coefficients) -> torch.Tensor:
    """Plain version of ``chebyshev_coarse``: the PyTorch loop from the
    zero guess, the operator's apply as the matvec."""
    dims = tuple(dims)
    _check(b, dims)
    x, _ = chebyshev_steps(_apply(dims, diag, off), torch.zeros_like(b), b,
                           coefs)
    return x


@functools.lru_cache(maxsize=256)
def _coef_array(coefs: Coefficients, dtype: torch.dtype):
    """The launch's coefficients as host doubles: ``1 / theta`` as CUDA's
    ``r / theta`` computes it for a host scalar (a multiply by the
    reciprocal, taken in the arithmetic type: f32 for f32 and bf16, f64
    for f64), then ``c1, c2`` of every step."""
    theta, steps = coefs
    if dtype == torch.float64:
        inv = 1.0 / theta
    else:
        inv = float(np.float32(1.0) / np.float32(theta))
    vals = [inv] + [c for pair in steps for c in pair]
    return (ctypes.c_double * len(vals))(*vals)


def chebyshev_coarse(b: torch.Tensor, *, dims: Sequence[int], diag: float,
                     off: float, coefs: Coefficients) -> torch.Tensor:
    """Kernel M: ``len(coefs[1])`` Chebyshev steps from the zero guess on
    each grid of the contiguous ``b`` (a ``dims`` grid, or in 2D a stack
    of them) for the Dirichlet stencil ``(diag, off)``; returns x of
    ``b``'s shape and dtype (f32, bf16 or f64).  ``coefs`` from
    ``solvers/chebyshev.chebyshev_coefficients(lmin, lmax, steps,
    b.dtype)``."""
    dims = tuple(dims)
    _check(b, dims)
    if not build.on_cuda(b):
        return chebyshev_coarse_plain(b, dims=dims, diag=diag, off=off,
                                      coefs=coefs)
    if not fits(dims, len(coefs[1])):
        raise ValueError(f"kernel M takes at most {MAX_POINTS} points a grid "
                         f"and {MAX_STEPS} steps, got {dims} and "
                         f"{len(coefs[1])}")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    batch = b.numel() // math.prod(dims)
    name = "stencil3d" if len(dims) == 3 else "stencil2d"
    lib = build.load(name)
    x = torch.empty_like(b)
    rc = getattr(lib, f"{name}_chebyshev")(
        _DTYPE_CODE[b.dtype], b.data_ptr(), x.data_ptr(), batch, *dims, diag,
        off, _coef_array(coefs, b.dtype), len(coefs[1]), build.stream(b))
    build.check(lib, rc, f"{name}_chebyshev")
    build.count(f"{name}_chebyshev")
    return x
