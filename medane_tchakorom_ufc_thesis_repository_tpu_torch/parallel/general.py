"""Distributed general-sparse operators: MPIAIJ across shards (port of the
JAX package's ``parallel/general.py``).

The reference's ``create_matrix_sparse`` builds MPIAIJ matrices whose row
strips live on different ranks (``utils.c:139-155``).  Here the rows are
split into one strip per shard of the mesh; a matvec ``all_gather``s x
over the mesh and applies the strips, and the Krylov reductions reduce
over the mesh axes (``solvers/krylov.py`` with ``axis_name``).

* ``ShardedGeneralBSR``: each strip a block-ELL pack with GLOBAL
  sub-block-column ids and transposed ``(c, c)`` blocks, one padded width
  for all strips: kernel I's format where ``c`` is one of kernel I's
  block sizes, and then this process's strips are one launch of kernel I
  (``ops.bsr.bsr_mv``) against the gathered x; other block sizes take the
  plain batched product (``_local_mv``), as JAX applies every strip.
* ``ShardedAIJ``: each strip a CSR with global column ids; this process's
  strips are consecutive rows of one CSR, multiplied by kernel H
  (``ops.csr.csr_mv``, with its chunk partition ``csr_partition``) against
  the gathered x.  JAX holds a Clos-routed gather plan per strip
  (``aij_mv_pallas``); that pack is not ported, the COO triplets build
  the CSR.
* ``ShardedBlockJacobi``: the strip-local diagonal-block inverses, one
  batched product a shard, no collectives.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.bsr import (
    BLOCK_SIZES,
    bsr_mv,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.csr import (
    csr_mv,
    csr_partition,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
)

METHODS = ("gmres", "cg", "bicgstab")


@dataclasses.dataclass(frozen=True)
class ShardedGeneralBSR:
    """Row-strip block-ELL operator: strip d owns rows ``[d*strip,
    (d+1)*strip)``; ``idx`` ``(ndev, nbr, w)`` holds global
    sub-block-column ids, ``val`` ``(ndev, nbr, w, c, c)`` the transposed
    sub-blocks; ``n`` is the true global dimension."""

    idx: torch.Tensor
    val: torch.Tensor
    n: int

    @property
    def ndev(self) -> int:
        return self.idx.shape[0]

    @property
    def c(self) -> int:
        return self.val.shape[-1]

    @property
    def strip(self) -> int:
        return self.idx.shape[1] * self.c

    @property
    def dtype(self):
        return self.val.dtype


def _strips(n: int, ndev: int) -> int:
    if n % ndev:
        raise ValueError(f"n={n} not divisible by ndev={ndev}")
    return n // ndev


def shard_general_from_coo(rows, cols, vals, n: int, ndev: int, c: int = 8,
                           dtype: torch.dtype = torch.float32,
                           device=None) -> ShardedGeneralBSR:
    """Host-side pack: COO -> one block-ELL strip per shard (a shared
    padded width), on ``device`` (None: the current CUDA device).  ``n``
    must be divisible by ``ndev`` and the strip by ``c``."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
        _bsr_pack_np,
    )

    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    strip = _strips(n, ndev)
    if strip % c:
        raise ValueError(f"strip={strip} not divisible by c={c}")
    packs = []
    for d in range(ndev):
        m = (rows >= d * strip) & (rows < (d + 1) * strip)
        packs.append(_bsr_pack_np(rows[m] - d * strip, cols[m], vals[m],
                                  (strip, n), c))
    w = max(p[0].shape[1] for p in packs)
    nbr = strip // c
    idx = np.zeros((ndev, nbr, w), np.int32)
    val = np.zeros((ndev, nbr, w, c, c))
    for d, (i_, v_) in enumerate(packs):
        idx[d, :, : i_.shape[1]] = i_
        val[d, :, : v_.shape[1]] = v_
    dev = resolve(device)
    return ShardedGeneralBSR(idx=torch.from_numpy(idx).to(dev),
                             val=torch.from_numpy(val).to(dev, dtype),
                             n=int(n))


@dataclasses.dataclass(frozen=True)
class ShardedBlockJacobi:
    """Row-strip block-Jacobi PC (PETSc PCBJACOBI across ranks): ``inv``
    ``(ndev, nb_local, bs, bs)``, strip d's diagonal-block inverses."""

    inv: torch.Tensor

    @property
    def bs(self) -> int:
        return self.inv.shape[-1]


def shard_bjacobi_from_coo(rows, cols, vals, n: int, ndev: int,
                           bs: int = 64, dtype: torch.dtype = torch.float32,
                           device=None) -> ShardedBlockJacobi:
    """Host-side set-up: the global block-diagonal inverses (f64, pinv
    fallback: ``solvers.bjacobi``), one strip of blocks per shard.  ``bs``
    must divide the strip, so that no block straddles two shards."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.bjacobi import (
        block_jacobi_from_coo,
    )

    strip = _strips(n, ndev)
    if strip % bs:
        raise ValueError(
            f"pc block size {bs} must divide the per-device strip {strip} "
            "(PC blocks must not straddle device boundaries)")
    M = block_jacobi_from_coo(rows, cols, vals, n, bs=bs, dtype=dtype,
                              device=device)
    nb = M.inv_blocks.shape[0]
    return ShardedBlockJacobi(inv=M.inv_blocks.reshape(ndev, nb // ndev, bs,
                                                       bs))


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"method must be 'gmres' | 'cg' | 'bicgstab', got "
                         f"{method!r}")


def _local_ids(mesh, ndev: int):
    """This process's shard ids (row-major over the mesh), and whether
    they are one run of consecutive strips."""
    if mesh.size != ndev:
        raise ValueError(f"operator packed for {ndev} devices, mesh has "
                         f"{mesh.size}")
    ids = mesh.shard_index().reshape(-1).tolist()
    return ids, ids == list(range(ids[0], ids[0] + len(ids)))


def _gathered(mesh, x: torch.Tensor) -> torch.Tensor:
    """The full x from the shards' rows ``(shards, strip)``, one copy."""
    xs = x.reshape(mesh.local_shape + x.shape[1:])
    return mesh.local(mesh.all_gather(xs, tuple(mesh.axis_names), axis=0,
                                      tiled=True))


def _local_mv(idx, val, x_full, n_out: int, n_in: int) -> torch.Tensor:
    """Block rows' y from the full x (global block-column ids), in plain
    PyTorch: a block size kernel I does not take."""
    c = val.shape[-1]
    g = x_full.reshape(-1, c)[idx.long()]                  # (nbr, w, c)
    return torch.einsum("rwji,rwj->ri", val, g).reshape(-1)[:n_out]


def _krylov(method, mesh, mv, b_loc, *, restart, maxiter, rtol, pc=None):
    """The three methods of the sharded general solves, with an optional
    strip-local ``pc``: the true-residual preconditioner of CG, the right
    preconditioner of BiCGStab and GMRES (so their tests see the true
    residual; the reference's ``KSPSetPCSide PC_RIGHT``, utils.c:524)."""
    axes = tuple(mesh.axis_names)
    if method == "cg":
        return krylov.cg(mv, b_loc, maxiter=maxiter, rtol=rtol,
                         axis_name=axes, mesh=mesh, precond=pc)
    if method == "bicgstab":
        return krylov.bicgstab(mv, b_loc, maxiter=maxiter, rtol=rtol,
                               axis_name=axes, mesh=mesh, precond=pc)
    amv = mv if pc is None else (lambda v: mv(pc(v)))
    res = krylov.gmres(amv, b_loc, restart=restart, maxiter=maxiter,
                       rtol=rtol, axis_name=axes, mesh=mesh)
    if pc is None:
        return res
    return dataclasses.replace(res, x=pc(res.x))


def _result(mesh, spec, n, res):
    x = mesh.unshard(res.x.reshape(mesh.local_shape + res.x.shape[1:]),
                     spec, (n,))
    return krylov.KrylovResult(x=x, iters=res.iters[0], resnorm=res.resnorm[0],
                               resnorm0=res.resnorm0[0],
                               converged=res.converged[0], syncs=res.syncs)


def sharded_general_solve(mesh, op: ShardedGeneralBSR, b: torch.Tensor, *,
                          method: str = "gmres", restart: int = 30,
                          maxiter: int = 2000, rtol: float = 1e-6,
                          pc: Optional[ShardedBlockJacobi] = None
                          ) -> krylov.KrylovResult:
    """``A x = b`` for a row-sharded block-ELL operator by GMRES(restart),
    CG (SPD) or BiCGStab, reductions over the whole mesh; ``pc`` an
    optional strip-local block-Jacobi.  ``b`` and ``x`` are global."""
    _check_method(method)
    ids, _ = _local_ids(mesh, op.ndev)
    if pc is not None and pc.inv.shape[0] != op.ndev:
        raise ValueError(f"pc packed for {pc.inv.shape[0]} devices, operator "
                         f"for {op.ndev}")
    sel = torch.tensor(ids, device=op.idx.device)
    # this process's strips as one pack: one launch of kernel I
    idx = op.idx[sel].reshape(-1, op.idx.shape[-1]).contiguous()
    val = op.val[sel].reshape(-1, *op.val.shape[2:]).contiguous()
    nsh, strip = len(ids), op.strip

    product = bsr_mv if op.c in BLOCK_SIZES else _local_mv

    def mv(x):
        y = product(idx, val, _gathered(mesh, x), nsh * strip, op.n)
        return y.reshape(nsh, strip)

    apply_pc = None
    if pc is not None:
        inv = pc.inv[sel].to(op.dtype)

        def apply_pc(r):
            rb = r.reshape(nsh, inv.shape[1], pc.bs, 1)
            return full_matmul(inv, rb).reshape(nsh, strip)

    spec = (tuple(mesh.axis_names),)
    b_loc = mesh.shard(b.to(op.dtype), spec).reshape(nsh, strip)
    res = _krylov(method, mesh, mv, b_loc, restart=restart, maxiter=maxiter,
                  rtol=rtol, pc=apply_pc)
    return _result(mesh, spec, op.n, res)


# ---------------------------------------------------------------------------
# Row-strip AIJ on kernel H
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedAIJ:
    """Row-strip CSR operator: strip d owns rows ``[d*strip, (d+1)*strip)``
    with global column ids.  ``indptr``/``indices``/``data`` hold every
    strip, in row order (the strips of a process are consecutive rows)."""

    indptr: torch.Tensor     # int32 (n + 1,)
    indices: torch.Tensor    # int32 (nnz,)
    data: torch.Tensor       # (nnz,)
    n: int
    ndev: int

    @property
    def strip(self) -> int:
        return self.n // self.ndev

    @property
    def dtype(self):
        return self.data.dtype

    def rows(self, first: int, count: int):
        """The CSR of ``count`` strips from strip ``first`` and its chunk
        partition (kernel H's split), built once per run of strips."""
        return _rows(self, first, count)


@lru_cache(maxsize=16)
def _rows(op: ShardedAIJ, first: int, count: int):
    lo, hi = first * op.strip, (first + count) * op.strip
    ptr = op.indptr[lo:hi + 1]
    start, stop = int(ptr[0]), int(ptr[-1])
    indptr = (ptr - start).to(torch.int32).contiguous()
    indices = op.indices[start:stop].contiguous()
    data = op.data[start:stop].contiguous()
    return indptr, indices, data, csr_partition(indptr, stop - start)


def shard_aij_from_coo(rows, cols, vals, n: int, ndev: int,
                       dtype: torch.dtype = torch.float32,
                       device=None) -> ShardedAIJ:
    """Host-side pack: COO -> the strips' CSR (duplicates summed, columns
    sorted within a row), on ``device`` (None: the current CUDA device).
    ``n`` must be divisible by ``ndev``."""
    import scipy.sparse as sp

    A = sp.csr_matrix((np.asarray(vals, np.float64),
                       (np.asarray(rows), np.asarray(cols))), shape=(n, n))
    return shard_aij_from_scipy(A, ndev, dtype=dtype, device=device)


def shard_aij_from_scipy(A, ndev: int, dtype: torch.dtype = torch.float32,
                         device=None) -> ShardedAIJ:
    """``shard_aij_from_coo`` from a square scipy sparse matrix."""
    A = A.tocsr()
    n = A.shape[0]
    _strips(n, ndev)
    A.sum_duplicates()
    A.sort_indices()
    dev = resolve(device)
    return ShardedAIJ(
        indptr=torch.from_numpy(A.indptr.astype(np.int32)).to(dev),
        indices=torch.from_numpy(A.indices.astype(np.int32)).to(dev),
        data=torch.from_numpy(A.data).to(dev, dtype), n=int(n),
        ndev=int(ndev))


def sharded_aij_solve(mesh, op: ShardedAIJ, b: torch.Tensor, *,
                      method: str = "gmres", restart: int = 30,
                      maxiter: int = 2000, rtol: float = 1e-6
                      ) -> krylov.KrylovResult:
    """GMRES/CG/BiCGStab on a row-sharded CSR operator: the gathered x,
    this process's strips in one launch of kernel H, reductions over the
    whole mesh (MPIAIJ MatMult + KSP for structureless matrices)."""
    _check_method(method)
    ids, consecutive = _local_ids(mesh, op.ndev)
    if not consecutive:
        raise ValueError(f"this process's strips {ids} are not consecutive "
                         "rows; shape the mesh so that they are")
    indptr, indices, data, part = op.rows(ids[0], len(ids))
    nsh, strip = len(ids), op.strip

    def mv(x):
        y = csr_mv(indptr, indices, data, _gathered(mesh, x), nsh * strip,
                   op.n, partition=part)
        return y.reshape(nsh, strip)

    spec = (tuple(mesh.axis_names),)
    b_loc = mesh.shard(b.to(op.dtype), spec).reshape(nsh, strip)
    res = _krylov(method, mesh, mv, b_loc, restart=restart, maxiter=maxiter,
                  rtol=rtol)
    return _result(mesh, spec, op.n, res)
