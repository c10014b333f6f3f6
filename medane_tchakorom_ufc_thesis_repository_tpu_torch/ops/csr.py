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

The kernel splits the nonzeros into chunks of ``CHUNK``, one thread block
each; a block owns the rows that start in its chunk, and a row that runs
on into later chunks takes one carry from each, added in block order by a
second launch.  The host pieces of that split are plain functions here:
``csr_blocks`` (the number of chunks), ``csr_partition`` (each chunk's
first row, built once per matrix and kept on the ``AIJ``) and
``csr_carry_size`` (the scratch the carries take).

The wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each launch adds one to
``launch_counts()["csr_mv"]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.float64: 2}
CHUNK = 2048        # nonzeros a thread block owns (csrc/csr_mv.cu CHUNK)
BATCH = 4           # vectors of a batch in one pass over the matrix


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


def csr_blocks(nnz: int) -> int:
    """Thread blocks of the kernel: one a chunk of ``CHUNK`` nonzeros, and
    one for a matrix without any."""
    return max(1, -(-nnz // CHUNK))


def csr_partition(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Each chunk's first row, ``nrows`` last: int32 ``(csr_blocks(nnz) +
    1,)`` on ``indptr``'s device.  Chunk ``c`` owns the rows whose first
    entry lies in ``[c CHUNK, (c + 1) CHUNK)``, and the last chunk also the
    empty rows after the last nonzero, so its first row is the first ``i``
    with ``indptr[i] >= c CHUNK``.  Computed on the device, no host read."""
    nrows = indptr.shape[0] - 1
    starts = torch.arange(csr_blocks(nnz), dtype=torch.int64,
                          device=indptr.device) * CHUNK
    first = torch.searchsorted(indptr.long(), starts, side="left")
    last = torch.full((1,), nrows, dtype=first.dtype, device=indptr.device)
    return torch.cat([first, last]).to(torch.int32)


def csr_carry_size(nnz: int) -> int:
    """Values of the carry scratch: ``BATCH`` a chunk (and as many int32
    rows, one a chunk)."""
    return csr_blocks(nnz) * BATCH


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
           x: torch.Tensor, nrows: int, ncols=None,
           partition: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel H (replaces ``aij_pallas.aij_mv_pallas``): ``y = A x`` for a
    CSR matrix with ``nrows`` rows and ``ncols`` columns (``x.shape[-1]``
    when not given; given, ``x`` is held to it before the launch, since
    the kernel gathers ``x[indices[p]]`` unchecked).  ``partition`` is
    ``csr_partition(indptr, nnz)``, built here when not given (an ``AIJ``
    keeps its own).  Chunks of nonzeros, fixed-order sums and carries: the
    same bits on every launch."""
    _check(indptr, indices, data, x, nrows, ncols)
    if not build.on_cuda(x):
        return csr_mv_plain(indptr, indices, data, x, nrows, ncols)
    nnz = data.shape[0]
    if partition is None:
        partition = csr_partition(indptr, nnz)
    elif (partition.dtype != torch.int32 or partition.device != x.device
          or tuple(partition.shape) != (csr_blocks(nnz) + 1,)):
        raise ValueError(f"partition must be int32 ({csr_blocks(nnz) + 1},) "
                         f"on {x.device}, got {partition.dtype}"
                         f"{tuple(partition.shape)} on {partition.device}")
    lib = build.load("csr_mv")
    k = 1 if x.dim() == 1 else x.shape[0]
    # the kernel reads x as (ncols, k): a nonzero's k values side by side
    xc = x.contiguous() if k == 1 else x.t().contiguous()
    y = torch.empty(x.shape[:-1] + (nrows,), dtype=x.dtype, device=x.device)
    carry = torch.empty(csr_carry_size(nnz), dtype=x.dtype, device=x.device)
    carry_row = torch.empty(csr_blocks(nnz), dtype=torch.int32,
                            device=x.device)
    rc = lib.csr_mv(_DTYPE_CODE[x.dtype], indptr.data_ptr(),
                    indices.data_ptr(), data.data_ptr(), partition.data_ptr(),
                    xc.data_ptr(), y.data_ptr(), carry.data_ptr(),
                    carry_row.data_ptr(), nrows, x.shape[-1], nnz, k,
                    build.stream(x))
    build.check(lib, rc, "csr_mv")
    build.count("csr_mv")
    return y
