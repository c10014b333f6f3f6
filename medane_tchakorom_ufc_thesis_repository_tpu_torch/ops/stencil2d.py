"""The 2D 5-point stencil kernel: wrapper, plain version, launch counts.

Counterpart of the 2D half of the JAX package's ``ops/stencil_pallas.py``
(``stencil2d_mv_pallas``) and of ``ops/fused_pallas.stencil2d_spmm_pallas``.
One hand-written CUDA kernel (kernel E, ``csrc/stencil2d.cu``) applies the
Dirichlet 5-point operator to a batch of ``(m, n)`` grids, each bounded by
zeros: a single grid (``Stencil2D.mv``), the stack of multisplitting strips
(``StackedStencil2D.diag_mv``), or an ``(s, m, n)`` basis panel
(``StackedStencil2D.full_mv`` over the s-step basis, ``R = A S``).

The kernel walks row tiles staged in shared memory with 16-byte copies;
its launcher chooses the tile and the slab of rows a block walks from the
shape and dtype.
The wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  Storage and arithmetic are f32
or f64 on both paths; bf16 storage (the level-0 applies of a bf16
multigrid cycle) computes in f32 and rounds once, on both paths.  The taps are summed in one order everywhere, that of
the JAX ``StackedStencil2D.diag_mv``: ``diag*c + off*(((n + s) + w) + e)``.
Each launch adds one to ``launch_counts()["stencil2d_apply[mv]"]``, or to
``[spmm]`` when the batch is a basis panel (``panel=True``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def _check(x: torch.Tensor) -> None:
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty (batch, m, n) array, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"stencil2d_apply takes {tuple(_DTYPE_CODE)}, got "
                         f"{x.dtype}")


def stencil2d_apply_plain(x: torch.Tensor, *, diag: float,
                          off: float) -> torch.Tensor:
    """Plain version of ``stencil2d_apply``: ``A x`` on each ``(m, n)``
    grid of ``x``, zero outside it, in ``x``'s dtype (bf16: computed in
    f32 and rounded once)."""
    _check(x)
    c = x.to(torch.promote_types(x.dtype, torch.float32))
    p = F.pad(c, (1, 1, 1, 1))
    taps = ((p[:, :-2, 1:-1] + p[:, 2:, 1:-1]) + p[:, 1:-1, :-2]) + p[:, 1:-1, 2:]
    return (diag * c + off * taps).to(x.dtype)


def stencil2d_apply(x: torch.Tensor, *, diag: float, off: float,
                    panel: bool = False) -> torch.Tensor:
    """Kernel E (replaces ``stencil_pallas.stencil2d_mv_pallas`` and
    ``fused_pallas.stencil2d_spmm_pallas``): ``A x`` on each ``(m, n)``
    grid of the contiguous ``(batch, m, n)`` array ``x``.  ``panel`` only
    names the launch in the counts: True when the batch is a basis panel
    ``(s, m, n)``."""
    _check(x)
    if not build.on_cuda(x):
        return stencil2d_apply_plain(x, diag=diag, off=off)
    batch, m, n = x.shape
    lib = build.load("stencil2d")
    y = torch.empty_like(x)
    rc = lib.stencil2d_apply(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                             batch, m, n, diag, off, build.stream(x))
    kind = "spmm" if panel else "mv"
    build.check(lib, rc, f"stencil2d_apply[{kind}]")
    build.count(f"stencil2d_apply[{kind}]")
    return y
