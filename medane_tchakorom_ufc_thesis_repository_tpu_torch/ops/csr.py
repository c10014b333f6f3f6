"""Sparse matrix-vector product in CSR, for any sparsity pattern.

Counterpart of the JAX package's ``ops/aij_pallas.aij_mv_pallas``: the
product behind ``core.operators.AIJ.mv`` and ``AIJ.rmv``.  One
hand-written CUDA kernel (``csrc/csr_mv.cu``, kernel H)::

    y[b, i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[b, indices[p]]

``indptr`` ``(nrows + 1,)`` and ``indices`` ``(nnz,)`` are int32, ``data``
``(nnz,)`` and ``x`` are f32 or f64 (sums in that type); ``x`` is one
vector ``(ncols,)`` or a batch ``(k, ncols)`` and ``y`` has the matching
shape.  The transpose product is the same call on the CSR arrays of the
transpose.

The wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each launch adds one to
``launch_counts()["csr_mv"]``.
"""

from __future__ import annotations

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.float64: 2}


def _check(indptr, indices, data, x, nrows: int, ncols=None) -> None:
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError(f"indptr and indices must be int32, got "
                         f"{indptr.dtype}, {indices.dtype}")
    if tuple(indptr.shape) != (nrows + 1,) or nrows < 1:
        raise ValueError(f"indptr has shape {tuple(indptr.shape)}, expected "
                         f"({nrows + 1},) with nrows >= 1")
    if indices.dim() != 1 or indices.shape != data.shape:
        raise ValueError(f"indices {tuple(indices.shape)} and data "
                         f"{tuple(data.shape)} must be equal 1D shapes")
    if data.dtype not in _DTYPE_CODE or x.dtype != data.dtype:
        raise ValueError(f"data and x must share one of {tuple(_DTYPE_CODE)},"
                         f" got {data.dtype}, {x.dtype}")
    if x.dim() not in (1, 2) or x.shape[-1] < 1 or x.shape[0] < 1:
        raise ValueError(f"x must be (ncols,) or (k, ncols), got "
                         f"{tuple(x.shape)}")
    if ncols is not None and x.shape[-1] != ncols:
        # a shorter x would be gathered out of bounds on the card
        raise ValueError(f"x has {x.shape[-1]} entries a vector, the matrix "
                         f"{ncols} columns")
    for name, t in (("indptr", indptr), ("indices", indices), ("data", data)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def group_lanes(nnz: int, nrows: int) -> int:
    """Lanes the kernel gives one row: the largest power of two not above
    the mean row length, between 2 and 32."""
    mean = nnz / max(nrows, 1)
    g = 2
    while g < 32 and 2 * g <= mean:
        g *= 2
    return g


def csr_mv_plain(indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, x: torch.Tensor,
                 nrows: int, ncols=None) -> torch.Tensor:
    """Plain version of ``csr_mv``: gather, multiply, and add each
    product to its row."""
    _check(indptr, indices, data, x, nrows, ncols)
    rows = torch.repeat_interleave(
        torch.arange(nrows, device=x.device),
        (indptr[1:] - indptr[:-1]).long())
    prod = data * x[..., indices.long()]
    y = torch.zeros(x.shape[:-1] + (nrows,), dtype=x.dtype, device=x.device)
    return y.index_add_(-1, rows, prod)


def csr_mv(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
           x: torch.Tensor, nrows: int, ncols=None) -> torch.Tensor:
    """Kernel H (replaces ``aij_pallas.aij_mv_pallas``): ``y = A x`` for a
    CSR matrix with ``nrows`` rows and ``ncols`` columns (``x.shape[-1]``
    when not given; given, ``x`` is held to it before the launch, since
    the kernel gathers ``x[indices[p]]`` unchecked).  A group of lanes per
    row and a fixed-order shuffle sum: the same bits on every launch."""
    _check(indptr, indices, data, x, nrows, ncols)
    if not build.on_cuda(x):
        return csr_mv_plain(indptr, indices, data, x, nrows, ncols)
    lib = build.load("csr_mv")
    k = 1 if x.dim() == 1 else x.shape[0]
    # the kernel reads x as (ncols, k): a nonzero's k values side by side
    xc = x.contiguous() if k == 1 else x.t().contiguous()
    y = torch.empty(x.shape[:-1] + (nrows,), dtype=x.dtype, device=x.device)
    rc = lib.csr_mv(_DTYPE_CODE[x.dtype], group_lanes(data.shape[0], nrows),
                    indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                    xc.data_ptr(), y.data_ptr(), nrows, x.shape[-1], k,
                    build.stream(x))
    build.check(lib, rc, "csr_mv")
    build.launches["csr_mv"] += 1
    return y
