"""Linear operators: the matrix-free Poisson stencils and the assembled
sparse formats, with the routing that picks a format for a matrix.

Port of the JAX package's ``core/operators.py`` under the same class
names, so that ``info["operator"]`` reads the same in both packages.

``Stencil2D`` / ``Stencil3D``
    Matrix-free 5-/7-point operators.  Every method goes through one
    kernel of ``ops/stencil2d.py`` or ``ops/stencil3d.py``, at every size
    and shape.  Methods take the flat vector or the grid and return the
    same shape; unknown order is the grid flattened C-style.
``StencilStrip2D`` / ``StencilStrip3D``
    One block's row strip of those operators: ``mv`` is the strip's
    diagonal block (kernel E or A), ``coupling`` the halo term.
``DenseOp``, ``DIA``, ``ELL``
    Dense, diagonal and ELLPACK storage; their products are plain PyTorch
    (a matmul, shifted slices, a gather and row sum), as the JAX package
    computes them outside any kernel.
``BSR``
    Block-ELL storage with transposed ``(bs, bs)`` blocks; ``mv`` and
    ``rmv`` run kernel I (``ops/bsr.py``).
``AIJ``
    Any sparsity pattern, stored as CSR (and the CSR of the transpose
    for ``rmv``); ``mv`` and ``rmv`` run kernel H (``ops/csr.py``).

The assembled formats are frozen dataclasses holding tensors, each with
``.to(device)``.  ``mv`` and ``rmv`` take one vector ``(n,)`` or a batch
``(k, n)``.  Packs are built on the host in numpy and land on ``device``
(None: the current CUDA device).  On the CPU the kernels' plain versions
run instead.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.bsr import bsr_mv
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.csr import (
    csr_mv,
    csr_partition,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil2d import (
    stencil2d_apply,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
)


@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """Matrix-free 2D 5-point Poisson operator on an ``m x n`` grid (diag 4,
    off -1, Dirichlet): the rows of the reference's ``poisson2DMatrix``."""

    m: int
    n: int
    diag: float = 4.0
    off: float = -1.0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m * self.n, self.m * self.n)

    @property
    def nnz(self) -> int:
        return 5 * self.m * self.n - 2 * self.m - 2 * self.n

    @property
    def dims(self) -> Tuple[int, int]:
        return (self.m, self.n)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A x`` (kernel E) for the flat vector or the ``(m, n)`` grid,
        or for a stack of either (leading axes are a batch of grids, as
        under the JAX package's ``vmap``)."""
        y = stencil2d_apply(x.reshape(-1, self.m, self.n), diag=self.diag,
                            off=self.off)
        return y.reshape(x.shape)

    rmv = mv  # symmetric

    def to_dense(self, dtype: Optional[torch.dtype] = None,
                 device=None) -> torch.Tensor:
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import (
            poisson2d_dense_np,
        )

        return torch.as_tensor(
            poisson2d_dense_np(self.m, self.n, self.diag, self.off),
            dtype=torch.get_default_dtype() if dtype is None else dtype,
            device=resolve(device))


@dataclasses.dataclass(frozen=True)
class Stencil3D:
    """Matrix-free 3D 7-point Poisson operator (diag 6, off -1)."""

    nx: int
    ny: int
    nz: int
    diag: float = 6.0
    off: float = -1.0

    @property
    def dims(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def shape(self) -> Tuple[int, int]:
        size = self.nx * self.ny * self.nz
        return (size, size)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        return 7 * nx * ny * nz - 2 * (nx * ny + ny * nz + nx * nz)

    def _grid(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.dim() == 3 else t.reshape(self.dims)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A x``."""
        y = k.stencil3d_apply(self._grid(x), kind="mv", diag=self.diag,
                              off=self.off)
        return y.reshape(x.shape)

    rmv = mv  # symmetric

    def mv_dot(self, x: torch.Tensor):
        """``(A x, x · A x)``; the dot is an f32 sum, returned in
        ``x``'s dtype."""
        y, dot = k.stencil3d_apply(self._grid(x), kind="mv_dot",
                                   diag=self.diag, off=self.off)
        return y.reshape(x.shape), dot.to(x.dtype)

    def axpy_mv_dot(self, z: torch.Tensor, p: torch.Tensor, beta):
        """``(p', A p', p' · A p')`` with ``p' = z + beta p``: PCG's
        direction update, matvec and direction dot in one pass (kernel J;
        ``cg(matvec_axpy_dot=...)``).  ``beta`` is a number or a 0-d
        tensor, read on the device.  The dot is an f32 sum (f64 for f64
        grids)."""
        pn, ap, dot = k.stencil3d_axpy_mv_dot(
            self._grid(z), self._grid(p), beta, diag=self.diag, off=self.off)
        return pn.reshape(z.shape), ap.reshape(z.shape), dot

    def residual(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``b - A x``."""
        y = k.stencil3d_apply(self._grid(x), self._grid(b), kind="residual",
                              diag=self.diag, off=self.off)
        return y.reshape(x.shape)

    def jacobi_sweep(self, x: torch.Tensor, b: torch.Tensor, omega: float,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One damped-Jacobi sweep ``x + omega (b - A x)``, written at
        ``out_dtype`` (default ``x.dtype``)."""
        y = k.stencil3d_apply(self._grid(x), self._grid(b), kind="jacobi",
                              diag=self.diag, off=self.off, omega=omega,
                              out_dtype=out_dtype)
        return y.reshape(x.shape)

    def jacobi_sweep_dot(self, x: torch.Tensor, b: torch.Tensor,
                         omega: float,
                         out_dtype: Optional[torch.dtype] = None):
        """``(x', b · x')`` with ``x' = x + omega (b - A x)``: PCG's
        ``r · z`` taken in the cycle's last sweep (f32 dot)."""
        y, dot = k.stencil3d_apply(self._grid(x), self._grid(b),
                                   kind="jacobi_dot", diag=self.diag,
                                   off=self.off, omega=omega,
                                   out_dtype=out_dtype)
        return y.reshape(x.shape), dot

    def mv_cast(self, x: torch.Tensor, dtype: torch.dtype):
        """``(A x, x)``, both rounded to ``dtype``, in one pass: the entry
        of a reduced-precision multigrid cycle."""
        y, c = k.stencil3d_mv_cast(self._grid(x), diag=self.diag,
                                   off=self.off, out_dtype=dtype)
        return y.reshape(x.shape), c.reshape(x.shape)

    def prolong_jacobi(self, x: torch.Tensor, b: torch.Tensor,
                       e: torch.Tensor, omega: float) -> torch.Tensor:
        """``m + omega (b - A m)`` with ``m = x + P e``: the cycle's coarse
        correction fused with the first post-smoothing sweep.  ``e`` is the
        grid-shaped coarse correction."""
        y = k.stencil3d_prolong_jacobi(self._grid(x), self._grid(b), e,
                                       diag=self.diag, off=self.off,
                                       omega=omega)
        return y.reshape(x.shape)

    def residual_restrict(self, x: torch.Tensor, b: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
        """``scale * mean_{2x2x2}(b - A x)`` on the factor-2-coarsened
        grid (grid-shaped); the fine residual is never stored."""
        return k.stencil3d_residual_restrict(self._grid(x), self._grid(b),
                                             diag=self.diag, off=self.off,
                                             scale=scale)


def _strip_coupling(rows_shape, off: float, halo_top: torch.Tensor,
                    halo_bottom: torch.Tensor) -> torch.Tensor:
    """``A_ij x_j`` of a strip of shape ``rows_shape``: ``off`` times the
    peer's boundary row (2D) or plane (3D) on each cut side, flat."""
    c = torch.zeros(rows_shape, dtype=halo_top.dtype, device=halo_top.device)
    c[0] = off * halo_top.reshape(rows_shape[1:])
    c[-1] += off * halo_bottom.reshape(rows_shape[1:])
    return c.reshape(-1)


@dataclasses.dataclass(frozen=True)
class StencilStrip2D:
    """One block's row strip of the 2D operator, matrix-free: ``rows`` grid
    rows of ``n`` (``m / nblocks``, the reference's
    ``divideSubDomainIntoBlockMatrices``, ``utils.c:450-478``).  Split on
    grid rows, the coupling ``A_ij x_j`` is one halo row on each cut
    side."""

    rows: int
    n: int
    diag: float = 4.0
    off: float = -1.0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows * self.n, self.rows * self.n)

    @property
    def nnz(self) -> int:
        r, n = self.rows, self.n
        return 5 * r * n - 2 * r - 2 * n

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A_ii x`` with zero halos (kernel E), for the flat strip or the
        ``(rows, n)`` grid, or a stack of either."""
        y = stencil2d_apply(x.reshape(-1, self.rows, self.n), diag=self.diag,
                            off=self.off)
        return y.reshape(x.shape)

    rmv = mv  # A_ii is symmetric

    def coupling(self, halo_top: torch.Tensor,
                 halo_bottom: torch.Tensor) -> torch.Tensor:
        """``A_ij x_j`` from the peer grid rows above (``halo_top``, zeros
        for the first block) and below (``halo_bottom``), each of ``n``."""
        return _strip_coupling((self.rows, self.n), self.off, halo_top,
                               halo_bottom)

    def mv_full(self, x, halo_top, halo_bottom) -> torch.Tensor:
        """The strip's full product ``A_ii x_i + A_ij x_j``, flat."""
        return self.mv(x).reshape(-1) + self.coupling(halo_top, halo_bottom)


@dataclasses.dataclass(frozen=True)
class StencilStrip3D:
    """One block's strip of the 3D operator, split on the x axis; halos are
    ``(ny, nz)`` planes."""

    rows: int
    ny: int
    nz: int
    diag: float = 6.0
    off: float = -1.0

    @property
    def shape(self) -> Tuple[int, int]:
        size = self.rows * self.ny * self.nz
        return (size, size)

    @property
    def nnz(self) -> int:
        r, ny, nz = self.rows, self.ny, self.nz
        return 7 * r * ny * nz - 2 * (r * ny + r * nz + ny * nz)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A_ii x`` with zero halos (kernel A, kind ``mv``), for the flat
        strip or the ``(rows, ny, nz)`` grid."""
        y = k.stencil3d_apply(x.reshape(self.rows, self.ny, self.nz),
                              kind="mv", diag=self.diag, off=self.off)
        return y.reshape(x.shape)

    rmv = mv

    def coupling(self, halo_top: torch.Tensor,
                 halo_bottom: torch.Tensor) -> torch.Tensor:
        return _strip_coupling((self.rows, self.ny, self.nz), self.off,
                               halo_top, halo_bottom)

    def mv_full(self, x, halo_top, halo_bottom) -> torch.Tensor:
        return self.mv(x).reshape(-1) + self.coupling(halo_top, halo_bottom)


# ---------------------------------------------------------------------------
# Assembled formats
# ---------------------------------------------------------------------------

def _moved(op, device):
    """``op`` with every tensor field on ``device``."""
    device = resolve(device)
    return dataclasses.replace(op, **{
        f.name: getattr(op, f.name).to(device)
        for f in dataclasses.fields(op)
        if isinstance(getattr(op, f.name), torch.Tensor)})


def _on(a: np.ndarray, device, dtype: Optional[torch.dtype] = None):
    """The numpy array as a contiguous tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=resolve(device), dtype=dtype)


@dataclasses.dataclass(frozen=True)
class DenseOp:
    """Dense matrix operator (the small-unstructured and small-rectangular
    route).  The products run in full f32: ``full_matmul`` refuses TF32."""

    a: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.a.dtype

    @property
    def nnz(self) -> int:
        return int(np.prod(self.a.shape))

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return full_matmul(x, self.a.T)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        return full_matmul(y, self.a)

    def to_dense(self) -> torch.Tensor:
        return self.a

    def to(self, device) -> "DenseOp":
        return _moved(self, device)


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK sparse matrix: ``indices``/``values`` of shape
    ``(nrows, width)``; padded slots carry value 0 and index 0."""

    indices: torch.Tensor   # int32 (nrows, width)
    values: torch.Tensor    # (nrows, width)
    ncols: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.indices.shape[0], self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def nnz(self) -> int:
        # padded count; the exact count is the caller's to track
        return int(self.indices.shape[0] * self.indices.shape[1])

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A x``: gather and a fixed-width row sum."""
        return torch.sum(self.values * x[..., self.indices.long()], dim=-1)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """``A^T y``: every stored product added to its column."""
        contrib = (self.values * y[..., None]).reshape(y.shape[:-1] + (-1,))
        out = torch.zeros(y.shape[:-1] + (self.ncols,), dtype=self.dtype,
                          device=y.device)
        return out.index_add_(-1, self.indices.reshape(-1).long(), contrib)

    def to_dense(self) -> torch.Tensor:
        n, w = self.indices.shape
        dense = torch.zeros((n, self.ncols), dtype=self.dtype,
                            device=self.values.device)
        rows = torch.arange(n, device=self.values.device).repeat_interleave(w)
        return dense.index_put_((rows, self.indices.reshape(-1).long()),
                                self.values.reshape(-1), accumulate=True)

    def to_coo_np(self):
        """Nonzero entries as numpy COO (rows, cols, vals)."""
        n, w = self.indices.shape
        rows = np.repeat(np.arange(n), w)
        cols = self.indices.cpu().numpy().reshape(-1)
        vals = self.values.cpu().numpy().reshape(-1)
        keep = vals != 0
        return rows[keep], cols[keep], vals[keep]

    def to_dia(self) -> "DIA":
        """The same matrix in DIA storage, on the same device."""
        if self.shape[0] != self.ncols:
            raise ValueError("DIA requires a square matrix")
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import (
            coo_to_dia,
        )

        rows, cols, vals = self.to_coo_np()
        return coo_to_dia(rows, cols, vals, self.shape, dtype=self.dtype,
                          device=self.values.device)

    def ndiags(self) -> int:
        """Number of distinct diagonals (host side)."""
        rows, cols, _ = self.to_coo_np()
        return len(np.unique(cols - rows))

    def to(self, device) -> "ELL":
        return _moved(self, device)


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage for banded matrices: ``data[d, i] = A[i, i +
    offsets[d]]`` (row-aligned; out-of-range slots are 0).  The product is
    a sum of shifted slices, no gathers."""

    data: torch.Tensor            # (ndiag, n)
    offsets: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.data.shape[1]
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nnz(self) -> int:
        n = self.data.shape[1]
        return sum(n - abs(o) for o in self.offsets)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        n = self.data.shape[1]
        maxo = max((abs(o) for o in self.offsets), default=0)
        xp = F.pad(x, (maxo, maxo))
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d] * xp[..., maxo + off: maxo + off + n]
        return y

    def rmv(self, x: torch.Tensor) -> torch.Tensor:
        """``A^T x``: each diagonal's product shifted by ``+off``."""
        n = self.data.shape[1]
        maxo = max((abs(o) for o in self.offsets), default=0)
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            zp = F.pad(self.data[d] * x, (maxo, maxo))
            y = y + zp[..., maxo - off: maxo - off + n]
        return y

    def to_dense(self) -> torch.Tensor:
        n = self.data.shape[1]
        dense = torch.zeros((n, n), dtype=self.dtype, device=self.data.device)
        for d, off in enumerate(self.offsets):
            # row-aligned: row i holds A[i, i + off]
            lo, hi = max(0, -off), min(n, n - off)
            rows = torch.arange(lo, hi, device=self.data.device)
            dense[rows, rows + off] += self.data[d, lo:hi]
        return dense

    def to(self, device) -> "DIA":
        return _moved(self, device)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse rows in block-ELL layout, for unstructured sparsity
    with block structure.  ``indices``/``values``: ``(nbr, width)``
    block-column ids and ``(nbr, width, bs, bs)`` blocks of A, each stored
    transposed; ``indices_t``/``values_t`` the same for A^T.  Padded
    slots carry index 0 and a zero block.  ``nrows``/``ncols`` are the
    true dimensions.  Both products run kernel I."""

    indices: torch.Tensor     # int32 (nbr, width)
    values: torch.Tensor      # (nbr, width, bs, bs)
    indices_t: torch.Tensor   # int32 (ncb, width_t)
    values_t: torch.Tensor    # (ncb, width_t, bs, bs)
    nrows: int
    ncols: int

    @property
    def bs(self) -> int:
        return self.values.shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def nnz(self) -> int:
        # stored (padded) count, like ELL.nnz
        return int(np.prod(self.values.shape))

    @property
    def fill(self) -> float:
        """Stored values per true nonzero (1.0 = no waste)."""
        return float(self.nnz) / max(int(torch.count_nonzero(self.values)), 1)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return bsr_mv(self.indices, self.values, x, self.nrows, self.ncols)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        return bsr_mv(self.indices_t, self.values_t, y, self.ncols,
                      self.nrows)

    def to_dense(self) -> torch.Tensor:
        nbr, width = self.indices.shape
        bs = self.bs
        ncb = -(-self.ncols // bs)
        dense = torch.zeros((nbr, ncb, bs, bs), dtype=self.dtype,
                            device=self.values.device)
        r = torch.arange(nbr, device=self.values.device).repeat_interleave(
            width)
        dense.index_put_((r, self.indices.reshape(-1).long()),
                         self.values.reshape(-1, bs, bs).transpose(1, 2),
                         accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(nbr * bs, ncb * bs)[
            : self.nrows, : self.ncols]

    @staticmethod
    def from_coo(rows, cols, vals, shape, bs: int = 128,
                 dtype: torch.dtype = torch.float32, device=None) -> "BSR":
        """Host-side (numpy) COO -> block-ELL pack of A and of A^T.  A
        symmetric matrix (detected exactly) shares the forward pack."""
        rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
        i, v = _bsr_pack_np(rows, cols, vals, shape, bs)
        iv, vv = _on(i, device), _on(v, device, dtype)
        if shape[0] == shape[1] and _coo_symmetric(rows, cols, vals):
            it, vt = iv, vv          # A^T = A: the same tensors
        else:
            it_, vt_ = _bsr_pack_np(cols, rows, vals, (shape[1], shape[0]),
                                    bs)
            it, vt = _on(it_, device), _on(vt_, device, dtype)
        return BSR(indices=iv, values=vv, indices_t=it, values_t=vt,
                   nrows=int(shape[0]), ncols=int(shape[1]))

    def to(self, device) -> "BSR":
        device = resolve(device)
        iv, vv = self.indices.to(device), self.values.to(device)
        if self.values_t is self.values:     # keep the shared pack shared
            return dataclasses.replace(self, indices=iv, values=vv,
                                       indices_t=iv, values_t=vv)
        return dataclasses.replace(
            self, indices=iv, values=vv, indices_t=self.indices_t.to(device),
            values_t=self.values_t.to(device))


def _sorted_csr(rows, cols, vals, shape):
    """The COO triplets as scipy CSR in f64, duplicates summed and every
    row sorted by column (a counting sort, no comparison sort)."""
    a = sp.coo_matrix((np.asarray(vals, np.float64),
                       (np.asarray(rows), np.asarray(cols))),
                      shape=(int(shape[0]), int(shape[1]))).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return a


def _same_csr(a, b) -> bool:
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def _bsr_pack_np(rows, cols, vals, shape, bs: int):
    """One-sided block-ELL pack: ``(indices (nbr, width) int32, values
    (nbr, width, bs, bs) f64)``, blocks in block-column order within a
    block row, each stored transposed (``blocks[b, j, i] = A_blk[i, j]``),
    duplicates summed in input order."""
    nrows, ncols = int(shape[0]), int(shape[1])
    nbr, ncb = -(-nrows // bs), -(-ncols // bs)
    br, bc = rows // bs, cols // bs
    # the distinct blocks, sorted by (block row, block column)
    pattern = _sorted_csr(br, bc, np.ones(len(rows), np.int8), (nbr, ncb))
    counts = np.diff(pattern.indptr)
    ubr = np.repeat(np.arange(nbr, dtype=np.int64), counts)
    ubc = pattern.indices.astype(np.int64)
    inv = np.searchsorted(ubr * ncb + ubc, br.astype(np.int64) * ncb + bc)
    width = max(int(counts.max()) if counts.size else 0, 1)
    slot = np.arange(len(ubr)) - np.repeat(
        pattern.indptr[:-1].astype(np.int64), counts)
    flat = (inv * bs + cols % bs) * bs + rows % bs
    blocks = np.bincount(flat, weights=vals, minlength=len(ubr) * bs * bs)
    indices = np.zeros((nbr, width), np.int32)
    values = np.zeros((nbr, width, bs, bs))
    indices[ubr, slot] = ubc.astype(np.int32)
    values[ubr, slot] = blocks.reshape(len(ubr), bs, bs)
    return indices, values


def _coo_symmetric(rows, cols, vals) -> bool:
    """Exact (structural and numeric) symmetry check, host side: A and A^T
    hold the same entries once duplicates are summed (packs sum them)."""
    if len(rows) == 0:
        return True
    n = int(max(rows.max(), cols.max())) + 1
    a = _sorted_csr(rows, cols, vals, (n, n))
    at = a.T.tocsr()
    at.sort_indices()
    return _same_csr(a, at)


@dataclasses.dataclass(frozen=True)
class AIJ:
    """General unstructured sparse operator (the PETSc MatAIJ analog): any
    pattern, square or rectangular, at any size, stored as CSR with
    duplicates summed and rows sorted by column.  ``rmv`` runs the same
    kernel on the CSR of the transpose (``t_*``; a symmetric matrix shares
    the forward arrays, ``with_rmv=False`` leaves them out).  Both
    products run kernel H, each with the chunk partition of its CSR,
    built once per matrix (and again by ``to``).

    The JAX package's AIJ compiles the pattern into a routed gather
    program because its hardware gather reaches one small tile; nothing
    of that pack has a counterpart here."""

    indptr: torch.Tensor               # int32 (nrows + 1,)
    indices: torch.Tensor              # int32 (nnz,)
    data: torch.Tensor                 # (nnz,)
    t_indptr: Optional[torch.Tensor]
    t_indices: Optional[torch.Tensor]
    t_data: Optional[torch.Tensor]
    nrows: int
    ncols: int
    # kernel H's chunk partitions (``ops.csr.csr_partition``) of the
    # forward and the transpose CSR, built with them
    partition: Optional[torch.Tensor] = None
    t_partition: Optional[torch.Tensor] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nnz(self) -> int:
        """Stored entries after coalescing."""
        return int(self.data.shape[0])

    @property
    def fill(self) -> float:
        return 1.0

    @staticmethod
    def from_coo(rows, cols, vals, shape, dtype: torch.dtype = torch.float32,
                 with_rmv: bool = True, device=None) -> "AIJ":
        """Host-side COO -> CSR.  ``with_rmv`` also keeps the CSR of the
        transpose, which a symmetric matrix (pattern and values equal,
        detected exactly) shares with the forward arrays."""
        nrows, ncols = int(shape[0]), int(shape[1])
        a = _sorted_csr(rows, cols, vals, shape)
        if a.nnz >= 2 ** 31:
            raise ValueError(f"{a.nnz} nonzeros do not fit int32 offsets")

        def arrays(m):
            return (_on(m.indptr.astype(np.int32), device),
                    _on(m.indices.astype(np.int32), device),
                    _on(m.data, device, dtype))

        fwd = arrays(a)
        tr = (None, None, None)
        if with_rmv:
            at = a.T.tocsr()
            at.sort_indices()
            tr = fwd if _same_csr(a, at) else arrays(at)
        return AIJ._with_partitions(fwd, tr, nrows, ncols)

    @staticmethod
    def _with_partitions(fwd, tr, nrows: int, ncols: int) -> "AIJ":
        """The AIJ of these CSR arrays, with the partition of each (one
        shared by shared arrays)."""
        part = csr_partition(fwd[0], fwd[2].shape[0])
        t_part = None
        if tr[2] is fwd[2]:
            t_part = part
        elif tr[2] is not None:
            t_part = csr_partition(tr[0], tr[2].shape[0])
        return AIJ(*fwd, *tr, nrows=nrows, ncols=ncols, partition=part,
                   t_partition=t_part)

    def to_dense(self) -> torch.Tensor:
        rows = torch.repeat_interleave(
            torch.arange(self.nrows, device=self.data.device),
            (self.indptr[1:] - self.indptr[:-1]).long())
        dense = torch.zeros(self.shape, dtype=self.dtype,
                            device=self.data.device)
        dense[rows, self.indices.long()] = self.data
        return dense

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return csr_mv(self.indptr, self.indices, self.data, x, self.nrows,
                      self.ncols, partition=self.partition)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        if self.t_data is None:
            raise ValueError("AIJ packed with with_rmv=False")
        return csr_mv(self.t_indptr, self.t_indices, self.t_data, y,
                      self.ncols, self.nrows, partition=self.t_partition)

    def to(self, device) -> "AIJ":
        device = resolve(device)
        fwd = tuple(t.to(device)
                    for t in (self.indptr, self.indices, self.data))
        if self.t_data is None:
            tr = (None, None, None)
        elif self.t_data is self.data:       # keep the shared arrays shared
            tr = fwd
        else:
            tr = tuple(t.to(device)
                       for t in (self.t_indptr, self.t_indices, self.t_data))
        return AIJ._with_partitions(fwd, tr, self.nrows, self.ncols)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def operator_from_coo(rows, cols, vals, shape,
                      dtype: torch.dtype = torch.float32,
                      max_diags: int = 64, max_bsr_cost: float = 16.0,
                      bsr_block_sizes: Tuple[int, ...] = (8, 16, 32, 64, 128),
                      max_dense_n: Optional[int] = None,
                      max_bsr_bytes: int = 2 << 30, device=None):
    """The ``create_matrix_sparse`` entry point: accept any sparsity
    pattern as COO and return the operator suited to it: banded ->
    ``DIA``, blockable -> ``BSR``, small unstructured or small rectangular
    -> ``DenseOp``, anything else -> ``AIJ``.

    ``max_dense_n`` defaults to the calibrated value for the current
    device (``core.calibration``)."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.calibration import (
        default_max_dense_n,
    )

    device = resolve(device)
    if max_dense_n is None:
        max_dense_n = default_max_dense_n()
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    if shape[0] == shape[1]:
        if _ndiags(rows, cols, shape) <= max_diags:
            return poisson.coo_to_dia(rows, cols, vals, shape, dtype=dtype,
                                      device=device)
        return _route_unbanded_square_coo(
            rows, cols, vals, shape, dtype, max_bsr_cost, bsr_block_sizes,
            max_dense_n, max_bsr_bytes=max_bsr_bytes,
            caller="operator_from_coo", device=device)
    if max(shape) <= max_dense_n:
        # small rectangular -> dense: the least-squares solvers drive rmv
        return _dense_from_coo(rows, cols, vals, shape, dtype, device)
    return AIJ.from_coo(rows, cols, vals, shape, dtype=dtype, device=device)


def _ndiags(rows, cols, shape) -> int:
    """Number of distinct diagonals of a COO pattern, without a sort."""
    if len(rows) == 0:
        return 0
    offs = np.asarray(cols, np.int64) - rows + (int(shape[0]) - 1)
    return int(np.count_nonzero(
        np.bincount(offs, minlength=int(shape[0]) + int(shape[1]) - 1)))


def _dense_from_coo(rows, cols, vals, shape, dtype, device=None) -> DenseOp:
    """Host-side COO -> DenseOp (duplicates coalesced by sum)."""
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (rows, cols), vals)
    return DenseOp(a=_on(dense, device, dtype))


def _route_unbanded_square_coo(rows, cols, vals, shape, dtype, max_bsr_cost,
                               bsr_block_sizes, max_dense_n,
                               max_bsr_bytes: int = 2 << 30, caller="",
                               device=None):
    """Shared routing tail for square non-banded patterns: BSR if the
    estimated cost clears ``max_bsr_cost``; dense if small; then a
    high-fill BSR whose estimated per-nonzero cost still undercuts the
    measured AIJ cost, as long as the pack fits in ``max_bsr_bytes``;
    otherwise AIJ."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.calibration import (
        aij_relative_cost,
        bsr_bs_penalty,
    )

    penalty = bsr_bs_penalty()
    best = None
    for bs in bsr_block_sizes:
        fill = bsr_block_fill_from_coo(rows, cols, shape, bs)
        cost = fill * penalty.get(bs, 1.0)
        if best is None or cost < best[1]:
            best = (bs, cost, fill)
    if best is not None and best[1] <= max_bsr_cost:
        return BSR.from_coo(rows, cols, vals, shape, bs=best[0], dtype=dtype,
                            device=device)
    if shape[0] <= max_dense_n:
        return _dense_from_coo(rows, cols, vals, shape, dtype, device)
    aij_cost = aij_relative_cost()
    if best is not None and best[1] < aij_cost:
        bs, cost, fill = best
        # values + transpose pack + indices: about 2.5x the stored values
        itemsize = torch.empty((), dtype=dtype).element_size()
        if 2.5 * fill * len(rows) * itemsize <= max_bsr_bytes:
            warnings.warn(
                f"{caller}: matrix is neither banded nor cleanly "
                f"blockable; using HIGH-fill BSR(bs={bs}) at an "
                f"estimated {cost:.0f}x per-nonzero cost — still "
                f"~{aij_cost / max(cost, 1e-9):.1f}x faster "
                "than the AIJ's CSR on kernel H (pass max_bsr_cost=inf to "
                "silence, or max_dense_n/max_bsr_cost to reroute)",
                UserWarning, stacklevel=3)
            return BSR.from_coo(rows, cols, vals, shape, bs=bs, dtype=dtype,
                                device=device)
    return AIJ.from_coo(rows, cols, vals, shape, dtype=dtype, device=device)


def from_scipy(A, dtype: torch.dtype = torch.float32, device=None,
               **route_kw):
    """``operator_from_coo`` over a ``scipy.sparse`` matrix."""
    coo = A.tocoo()
    return operator_from_coo(coo.row, coo.col, coo.data, coo.shape,
                             dtype=dtype, device=device, **route_kw)


def bsr_block_fill_from_coo(rows, cols, shape, bs: int) -> float:
    """Stored values per nonzero if packed as BSR(bs) (index-only).
    Counts the padded pack: block-ELL pads every block row to the widest
    row's block count, and the kernel reads padding like real blocks."""
    nbr = -(-int(shape[0]) // bs)
    ncb = -(-int(shape[1]) // bs)
    rows, cols = np.asarray(rows), np.asarray(cols)
    if len(rows) == 0:
        return 0.0
    # the distinct blocks of each block row
    pattern = _sorted_csr(rows // bs, cols // bs,
                          np.ones(len(rows), np.int8), (nbr, ncb))
    width = int(np.diff(pattern.indptr).max())
    return nbr * width * bs * bs / len(rows)


def as_routed_operator(op, max_diags: int = 64, max_bsr_cost: float = 16.0,
                       bsr_block_sizes: Tuple[int, ...] = (8, 16, 32, 64, 128),
                       max_dense_n: Optional[int] = None,
                       max_bsr_bytes: int = 2 << 30):
    """The representation suited to the card for ``op`` (counterpart of
    the JAX package's ``as_tpu_operator``): a square ``ELL`` matrix is
    routed as ``operator_from_coo`` routes its entries (banded -> ``DIA``,
    blockable -> ``BSR``, small -> ``DenseOp``, else ``AIJ``), on the
    device it lies on; any other operator is returned as it is."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.calibration import (
        default_max_dense_n,
    )

    if max_dense_n is None:
        max_dense_n = default_max_dense_n()
    if isinstance(op, ELL) and op.shape[0] == op.ncols:
        if op.ndiags() <= max_diags:
            return op.to_dia()
        rows, cols, vals = op.to_coo_np()
        return _route_unbanded_square_coo(
            rows, cols, vals, op.shape, op.dtype, max_bsr_cost,
            bsr_block_sizes, max_dense_n, max_bsr_bytes=max_bsr_bytes,
            caller="as_routed_operator", device=op.values.device)
    return op


def as_matvec(op):
    """A ``x -> A x`` closure for any operator."""
    return op.mv


def as_rmatvec(op):
    return op.rmv
