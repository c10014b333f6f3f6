"""Block-sparse (block-ELL) matrix-vector product.

Counterpart of the JAX package's ``ops/bsr_pallas.bsr_mv_pallas``: the
product behind ``core.operators.BSR.mv`` and ``BSR.rmv``.  One
hand-written CUDA kernel (``csrc/bsr_mv.cu``, kernel I)::

    y[b, r*bs + i] = sum_w sum_j values[r, w, j, i] * x[b, indices[r, w]*bs + j]

``indices`` ``(nbr, width)`` int32 holds block-column ids, ``values``
``(nbr, width, bs, bs)`` the blocks, each stored transposed, in f32 or
f64 (sums in that type); ``bs`` is a power of two from 8 to 128.  A padded
slot (index 0, zero block) is read like a real one.  ``x`` is one vector
``(n_in,)`` or a batch ``(k, n_in)``; ``n_in`` and ``n_out`` need not be
multiples of ``bs`` (``x`` is padded with zeros and ``y`` cut).

The wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each launch adds one to
``launch_counts()["bsr_mv"]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.float64: 2}
BLOCK_SIZES = (8, 16, 32, 64, 128)


def _check(indices, values, x, n_out: int, n_in: int) -> None:
    if indices.dtype != torch.int32 or indices.dim() != 2:
        raise ValueError(f"indices must be int32 (nbr, width), got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    nbr, width = indices.shape
    if (values.dim() != 4 or tuple(values.shape[:2]) != (nbr, width)
            or values.shape[2] != values.shape[3] or nbr < 1 or width < 1):
        raise ValueError(f"values must be (nbr, width, bs, bs) matching "
                         f"indices {tuple(indices.shape)}, got "
                         f"{tuple(values.shape)}")
    bs = values.shape[-1]
    if bs not in BLOCK_SIZES:
        raise ValueError(f"block size must be one of {BLOCK_SIZES}, got {bs}")
    if values.dtype not in _DTYPE_CODE or x.dtype != values.dtype:
        raise ValueError(f"values and x must share one of "
                         f"{tuple(_DTYPE_CODE)}, got {values.dtype}, "
                         f"{x.dtype}")
    if x.dim() not in (1, 2) or x.shape[-1] != n_in or x.shape[0] < 1:
        raise ValueError(f"x must be ({n_in},) or (k, {n_in}), got "
                         f"{tuple(x.shape)}")
    if not 0 < n_out <= nbr * bs:
        raise ValueError(f"n_out must be in (0, {nbr * bs}], got {n_out}")
    for name, t in (("indices", indices), ("values", values)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bsr_mv_plain(indices: torch.Tensor, values: torch.Tensor,
                 x: torch.Tensor, n_out: int, n_in: int) -> torch.Tensor:
    """Plain version of ``bsr_mv``: pad ``x``, gather its blocks, one
    batched contraction in full precision, cut ``y``."""
    _check(indices, values, x, n_out, n_in)
    if (x.is_cuda and x.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the block products need full f32; TF32 is allowed "
            "(torch.backends.cuda.matmul.allow_tf32)")
    bs = values.shape[-1]
    ncb = -(-n_in // bs)
    xb = F.pad(x, (0, ncb * bs - n_in)).reshape(x.shape[:-1] + (ncb, bs))
    g = xb[..., indices.long(), :]                 # (..., nbr, width, bs)
    y = torch.einsum("rwji,...rwj->...ri", values, g)
    return y.reshape(x.shape[:-1] + (-1,))[..., :n_out]


def bsr_mv(indices: torch.Tensor, values: torch.Tensor, x: torch.Tensor,
           n_out: int, n_in: int) -> torch.Tensor:
    """Kernel I (replaces ``bsr_pallas.bsr_mv_pallas``): ``y = A x`` for a
    block-ELL pack, one thread block per block row; the same bits on
    every launch."""
    _check(indices, values, x, n_out, n_in)
    if not build.on_cuda(x):
        return bsr_mv_plain(indices, values, x, n_out, n_in)
    lib = build.load("bsr_mv")
    xc = x.contiguous()
    k = 1 if x.dim() == 1 else x.shape[0]
    nbr, width = indices.shape
    y = torch.empty(x.shape[:-1] + (n_out,), dtype=x.dtype, device=x.device)
    rc = lib.bsr_mv(_DTYPE_CODE[x.dtype], indices.data_ptr(),
                    values.data_ptr(), xc.data_ptr(), y.data_ptr(), nbr,
                    width, values.shape[-1], n_out, n_in, k, build.stream(x))
    build.check(lib, rc, "bsr_mv")
    build.count("bsr_mv")
    return y
