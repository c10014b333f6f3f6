"""Stacked block operators (port of the JAX package's
``models/blockops.py``): the Jacobi-block decomposition as data layout.

The reference splits the global system into ``nblocks`` row strips, each
with its diagonal operator ``A_ii`` and its coupling ``A_ij``
(``divideSubDomainIntoBlockMatrices``, reference ``src/utils/utils.c:450-478``).
Here every block state is stacked along a leading axis, ``x`` of shape
``(nblocks, block_size)``, and the operators act on the whole stack:

* ``diag_mv(x)``: blockwise ``A_ii x_i``, each strip bounded by Dirichlet
  zeros at its cut rows;
* ``coupling_mv(x)``: blockwise ``sum_j A_ij x_j``, one halo row (2D) or
  plane (3D) per cut, plain tensor code as in JAX;
* ``full_mv(x)``: the global ``A x`` in stacked layout, where the cut
  rows see the neighbour strip.

``diag_mv`` and ``full_mv`` also take a basis panel ``(s, nblocks,
block_size)`` (the s-step minimization's ``A S``).  On the card the 2D
applies are kernel E (``ops/stencil2d.py``): ``diag_mv`` on the stack of
``(rows, n)`` strips, ``full_mv`` on the un-split ``(m, n)`` grid, one
grid per panel column.  The 3D applies are kernel A (``ops/stencil3d.py``,
kind ``mv``), one launch per strip or grid.

A general sparse matrix enters through ``core/poisson.block_split_ell``
(stacked ``(A_ii, A_ic)`` ELL planes, ``StackedELLOperator``), and
``as_stacked_routed_operator`` picks its representation: banded splits
become ``StackedDIAOperator`` (shifted slices, plain tensor code as in
JAX), blockable ones ``StackedBSROperator`` (kernel I, ``ops/bsr.py``),
and the rest stay on ``StackedELLOperator``, whose products run kernel H
(``ops/csr.py``) on a CSR of its planes.  Their ``diag_coo_np`` hook
gives the inner ``pc='bjacobi'`` its blocks.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core import poisson
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.calibration import (
    bsr_bs_penalty,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    AIJ,
    BSR,
    DIA,
    ELL,
    Stencil2D,
    Stencil3D,
    _bsr_pack_np,
    bsr_block_fill_from_coo,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.bsr import bsr_mv
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.bjacobi import (
    block_jacobi_from_coo,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil2d import (
    stencil2d_apply,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil3d import (
    stencil3d_apply,
)
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.chebyshev import (
    poisson_strip_eig_bounds_2d,
    poisson_strip_eig_bounds_3d,
)


class BlockOperator:
    """Interface of the stacked operators (duck-typed)."""

    nblocks: int
    block_size: int
    diag: float

    def diag_mv(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def coupling_mv(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def full_mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.diag_mv(x) + self.coupling_mv(x)

    def global_mv(self, x_flat: torch.Tensor) -> torch.Tensor:
        """The global ``A x`` on the merged ``(nblocks * block_size,)``
        vector."""
        nb, bs = self.nblocks, self.block_size
        return self.full_mv(x_flat.reshape(nb, bs)).reshape(-1)

    @property
    def dtype(self) -> torch.dtype:
        # matrix-free: no stored values; torch's default float width
        return torch.get_default_dtype()

    @property
    def diag_mv_args(self):
        """Per-block arrays of ``single_diag_mv``, stacked on a leading
        block axis; None for the uniform stencils, whose blocks share one
        operator."""
        return None

    def single_diag_vector(self, args, n: int) -> torch.Tensor:
        """The diagonal of ``A_ii`` (constant for the Dirichlet stencils;
        Jacobi preconditioning), as a length-``n`` f64 CPU tensor."""
        return torch.full((n,), self.diag, dtype=torch.float64)

    def _coupling(self, g: torch.Tensor) -> torch.Tensor:
        """``sum_j A_ij x_j`` on the stack of strips ``g`` (the cut axis
        is axis 1): ``off`` times the neighbours' boundary slices."""
        top, bottom = self._halos(g)
        c = torch.zeros_like(g)
        c[:, 0] = self.off * top
        c[:, -1] += self.off * bottom
        return c

    @staticmethod
    def _halos(g: torch.Tensor):
        zero = torch.zeros_like(g[:1, -1])
        top = torch.cat([zero, g[:-1, -1]], dim=0)
        bottom = torch.cat([g[1:, 0], zero], dim=0)
        return top, bottom


@dataclasses.dataclass(frozen=True)
class StackedStencil2D(BlockOperator):
    """2D 5-point Poisson on an ``m x n`` grid, matrix-free; block ``k``
    owns grid rows ``[k*rows, (k+1)*rows)``, ``rows = m // nblocks`` (the
    reference's ``poisson2DMatrix`` row order, ``utils.c:247-293``)."""

    m: int
    n: int
    nblocks: int = 2
    diag: float = 4.0
    off: float = -1.0

    def __post_init__(self):
        if self.m % self.nblocks:
            raise ValueError(f"m={self.m} not divisible by {self.nblocks}")

    @property
    def rows(self) -> int:
        return self.m // self.nblocks

    @property
    def block_size(self) -> int:
        return self.rows * self.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m * self.n, self.m * self.n)

    @property
    def nnz(self) -> int:
        return 5 * self.m * self.n - 2 * self.m - 2 * self.n

    def diag_mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A_ii x_i`` for every strip of ``x`` (``(nb, bs)``, or a panel
        ``(s, nb, bs)``): kernel E with the strips as its batch."""
        y = stencil2d_apply(x.reshape(-1, self.rows, self.n).contiguous(),
                            diag=self.diag, off=self.off, panel=x.dim() > 2)
        return y.reshape(x.shape)

    def single_diag_mv(self, args, xb: torch.Tensor) -> torch.Tensor:
        """``A_ii x_i`` for one block's ``x_i`` (or a stack of them);
        ``args`` is unused: every strip shares the operator."""
        return self.diag_mv(xb)

    def diag_eig_bounds(self):
        """Analytic spectral bounds of ``A_ii`` (Chebyshev inner solves)."""
        return poisson_strip_eig_bounds_2d(self.rows, self.n, self.diag,
                                           self.off)

    def diag_stencil_op(self) -> Stencil2D:
        """``A_ii`` as a standalone stencil operator on the ``(rows, n)``
        strip (inner ``pc='mg'``)."""
        return Stencil2D(self.rows, self.n, self.diag, self.off)

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.nblocks, self.rows, self.n)

    def halos(self, x: torch.Tensor):
        """Peer boundary rows for every block, ``(top, bottom)``, each
        ``(nb, n)``: ``top[k]`` is the last row of block ``k-1`` (zeros for
        k=0), ``bottom[k]`` the first row of block ``k+1``."""
        return self._halos(self._grid(x))

    def coupling_mv(self, x: torch.Tensor) -> torch.Tensor:
        return self._coupling(self._grid(x)).reshape(x.shape)

    def full_mv(self, x: torch.Tensor) -> torch.Tensor:
        """The global ``A x`` of ``x`` (``(nb, bs)``, or a panel ``(s, nb,
        bs)``): kernel E on the un-split ``(m, n)`` grid of each."""
        y = stencil2d_apply(x.reshape(-1, self.m, self.n).contiguous(),
                            diag=self.diag, off=self.off, panel=x.dim() > 2)
        return y.reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class StackedStencil3D(BlockOperator):
    """3D 7-point Poisson, blocks split on the leading grid axis (the
    reference's depth loop, ``poisson3DMatrix`` ``utils.c:30-121``); halos
    are ``(ny, nz)`` planes."""

    nx: int
    ny: int
    nz: int
    nblocks: int = 2
    diag: float = 6.0
    off: float = -1.0

    def __post_init__(self):
        if self.nx % self.nblocks:
            raise ValueError(f"nx={self.nx} not divisible by {self.nblocks}")

    @property
    def rows(self) -> int:
        return self.nx // self.nblocks

    @property
    def block_size(self) -> int:
        return self.rows * self.ny * self.nz

    @property
    def shape(self) -> Tuple[int, int]:
        size = self.nx * self.ny * self.nz
        return (size, size)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        return 7 * nx * ny * nz - 2 * (nx * ny + ny * nz + nx * nz)

    def _apply_each(self, grids: torch.Tensor) -> torch.Tensor:
        """Kernel A (kind ``mv``) on each grid of a contiguous stack, in one
        launch."""
        return stencil3d_apply(grids, kind="mv", diag=self.diag, off=self.off)

    def diag_mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A_ii x_i`` for every strip of ``x`` (``(nb, bs)`` or a panel
        ``(s, nb, bs)``): kernel A on each ``(rows, ny, nz)`` strip."""
        g = x.reshape(-1, self.rows, self.ny, self.nz).contiguous()
        return self._apply_each(g).reshape(x.shape)

    def single_diag_mv(self, args, xb: torch.Tensor) -> torch.Tensor:
        return self.diag_mv(xb)

    def diag_eig_bounds(self):
        return poisson_strip_eig_bounds_3d(self.rows, self.ny, self.nz,
                                           self.diag, self.off)

    def diag_stencil_op(self) -> Stencil3D:
        """``A_ii`` as a standalone stencil operator (see
        ``StackedStencil2D``)."""
        return Stencil3D(self.rows, self.ny, self.nz, self.diag, self.off)

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.nblocks, self.rows, self.ny, self.nz)

    def halos(self, x: torch.Tensor):
        return self._halos(self._grid(x))

    def coupling_mv(self, x: torch.Tensor) -> torch.Tensor:
        return self._coupling(self._grid(x)).reshape(x.shape)

    def full_mv(self, x: torch.Tensor) -> torch.Tensor:
        """The global ``A x``: kernel A on the un-split ``(nx, ny, nz)``
        grid of each of ``x`` (``(nb, bs)`` or a panel)."""
        g = x.reshape(-1, self.nx, self.ny, self.nz).contiguous()
        return self._apply_each(g).reshape(x.shape)


# ---------------------------------------------------------------------------
# General sparse matrices: stacked ELL, DIA and BSR
# ---------------------------------------------------------------------------

_SPARSE_DTYPES = (torch.float32, torch.float64)


def _check_dtype(name: str, dtype: torch.dtype) -> None:
    """Kernels H and I, and so the stacked sparse operators, take f32 and
    f64 only."""
    if dtype not in _SPARSE_DTYPES:
        raise ValueError(f"{name} takes {_SPARSE_DTYPES}, got {dtype}")


def _merged(x: torch.Tensor) -> torch.Tensor:
    """``(..., nb, bs)`` stacked blocks as ``(..., nb * bs)`` merged
    vectors (one vector, or a panel of them)."""
    return x.reshape(x.shape[:-2] + (-1,))


def _stacked_csr(ell: ELL, col_shift: int, ncols: int) -> AIJ:
    """The stacked planes ``(nb, bs, w)`` of ``ell`` as one CSR of
    ``ncols`` columns over the merged rows, on the planes' device: block
    ``b``'s column ids moved by ``b * col_shift``, padded slots (value 0)
    dropped, the entries of a row in their slot order.  No transpose: the
    products are forward."""
    idx, val = ell.indices, ell.values
    nb, bs, _ = idx.shape
    keep = val != 0
    shift = torch.arange(nb, device=idx.device) * col_shift
    cols = (idx.long() + shift[:, None, None])[keep]
    counts = keep.sum(dim=-1).reshape(-1)
    indptr = torch.zeros(nb * bs + 1, dtype=torch.int64, device=idx.device)
    torch.cumsum(counts, dim=0, out=indptr[1:])
    if cols.numel() >= 2 ** 31:
        raise ValueError(f"{cols.numel()} nonzeros do not fit int32 offsets")
    fwd = (indptr.to(torch.int32), cols.to(torch.int32), val[keep])
    return AIJ._with_partitions(fwd, (None, None, None), nb * bs, ncols)


class _SparseBlockOperator(BlockOperator):
    """What the three stacked sparse operators share: the inverses of
    each ``A_ii``'s diagonal sub-blocks (inner ``pc='bjacobi'``), built
    from their ``diag_coo_np`` hook once per sub-block size and kept in
    the ``inverses`` field."""

    def diag_block_inverses(self, p: int) -> torch.Tensor:
        """``(nblocks, nbb, p, p)``: each block's ``p x p`` diagonal
        sub-blocks inverted on the host in f64 (``solvers.bjacobi``), on
        the operator's device in its dtype."""
        if p not in self.inverses:
            self.inverses[p] = torch.stack([
                block_jacobi_from_coo(r, c, v, self.block_size, bs=p,
                                      dtype=self.dtype,
                                      device=self.device).inv_blocks
                for r, c, v in self.diag_coo_np()])
        return self.inverses[p]


def _inverses_field():
    return dataclasses.field(default_factory=dict, init=False, repr=False,
                             compare=False)


@dataclasses.dataclass(frozen=True)
class StackedELLOperator(_SparseBlockOperator):
    """General sparse path: stacked per-block ELL planes, as
    ``core.poisson.block_split_ell`` makes them.

    ``a_ii``: indices/values ``(nb, bs, w1)`` with block-local column ids;
    ``a_ic``: ``(nb, bs, w2)`` with global column ids (padded slots value
    0).  At construction both become one CSR over the merged vector (the
    ``A_ii`` stack block-diagonal, its column ids moved to global ones),
    each with kernel H's chunk partition as ``AIJ`` keeps it: ``diag_mv``
    and ``coupling_mv`` are one launch of kernel H each (its plain version
    on the CPU), on one vector or a panel."""

    a_ii: ELL
    a_ic: ELL
    csr_ii: AIJ = dataclasses.field(init=False, repr=False, compare=False)
    csr_ic: AIJ = dataclasses.field(init=False, repr=False, compare=False)
    inverses: dict = _inverses_field()

    def __post_init__(self):
        _check_dtype("StackedELLOperator", self.a_ii.values.dtype)
        n = self.nblocks * self.block_size
        object.__setattr__(self, "csr_ii",
                           _stacked_csr(self.a_ii, self.block_size, n))
        object.__setattr__(self, "csr_ic", _stacked_csr(self.a_ic, 0, n))

    @property
    def nblocks(self) -> int:
        return self.a_ii.indices.shape[0]

    @property
    def block_size(self) -> int:
        return self.a_ii.indices.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nblocks * self.block_size
        return (n, n)

    @property
    def nnz(self) -> int:
        return self.csr_ii.nnz + self.csr_ic.nnz

    @property
    def dtype(self) -> torch.dtype:
        return self.a_ii.values.dtype

    @property
    def device(self) -> torch.device:
        return self.a_ii.values.device

    def diag_mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A_ii x_i`` for every block of ``x`` (``(nb, bs)`` or a panel
        ``(s, nb, bs)``): kernel H on the block-diagonal CSR."""
        return self.csr_ii.mv(_merged(x)).reshape(x.shape)

    def coupling_mv(self, x: torch.Tensor) -> torch.Tensor:
        """``sum_j A_ij x_j``: kernel H on the coupling CSR."""
        return self.csr_ic.mv(_merged(x)).reshape(x.shape)

    @property
    def diag_mv_args(self):
        return (self.a_ii.indices, self.a_ii.values)

    def single_diag_mv(self, args, xb: torch.Tensor) -> torch.Tensor:
        """``A_ii x_i`` of one block (``args``: its ``(bs, w)`` planes) on
        ``xb`` ``(bs,)`` or a stack ``(k, bs)``: the gather and row sum."""
        idx, val = args
        return torch.sum(val * xb[..., idx.long()], dim=-1)

    def single_diag_vector(self, args, n: int) -> torch.Tensor:
        idx, val = args
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        return torch.sum(torch.where(idx == rows, val, 0.0), dim=-1)

    def diag_coo_np(self):
        """Per-block COO of ``A_ii`` on the host (the ``pc='bjacobi'``
        set-up hook): a list of ``(rows, cols, vals)`` numpy triples."""
        idx = self.a_ii.indices.cpu().numpy()
        val = self.a_ii.values.cpu().numpy()
        nb, bs, w = idx.shape
        rows = np.broadcast_to(np.arange(bs)[:, None], (bs, w))
        out = []
        for b in range(nb):
            m = val[b] != 0
            out.append((rows[m], idx[b][m], val[b][m]))
        return out

    def to_dense(self) -> torch.Tensor:
        nb, bs = self.nblocks, self.block_size
        n = nb * bs
        dense = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for b in range(nb):
            sl = slice(b * bs, (b + 1) * bs)
            dense[sl, sl] += ELL(self.a_ii.indices[b], self.a_ii.values[b],
                                 bs).to_dense()
            dense[sl, :] += ELL(self.a_ic.indices[b], self.a_ic.values[b],
                                n).to_dense()
        return dense


@dataclasses.dataclass(frozen=True)
class StackedDIAOperator(_SparseBlockOperator):
    """Banded general-sparse path: diagonal planes, no gathers.

    ``dia_ii``/``dia_ic`` are global row-aligned ``DIA`` planes over the
    merged ``(nb * bs,)`` vector: ``dia_ii`` holds the entries whose column
    lies in the row's own block, ``dia_ic`` the cross-block coupling.
    Their products are sums of shifted slices, plain tensor code as in
    JAX (no Pallas kernel there).  Build with ``from_stacked_ell``."""

    dia_ii: DIA
    dia_ic: DIA
    nblocks: int
    inverses: dict = _inverses_field()

    @property
    def block_size(self) -> int:
        return self.dia_ii.data.shape[1] // self.nblocks

    @property
    def shape(self) -> Tuple[int, int]:
        return self.dia_ii.shape

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.dia_ii.data)
                   + torch.count_nonzero(self.dia_ic.data))

    @property
    def dtype(self) -> torch.dtype:
        return self.dia_ii.dtype

    @property
    def device(self) -> torch.device:
        return self.dia_ii.data.device

    def diag_mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.dia_ii.mv(_merged(x)).reshape(x.shape)

    def coupling_mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.dia_ic.mv(_merged(x)).reshape(x.shape)

    @property
    def diag_mv_args(self):
        """``(nb, ndiag, bs)``: block ``i``'s local planes are the slice
        ``data[:, i bs:(i+1) bs]``, with the global offsets (rows and
        columns of ``A_ii`` shift together)."""
        nd = self.dia_ii.data.shape[0]
        return self.dia_ii.data.reshape(nd, self.nblocks,
                                        self.block_size).permute(1, 0, 2)

    def single_diag_mv(self, args, xb: torch.Tensor) -> torch.Tensor:
        data = args                      # (ndiag, bs)
        bs = xb.shape[-1]
        offs = self.dia_ii.offsets
        maxo = max((abs(o) for o in offs), default=0)
        xp = F.pad(xb, (maxo, maxo))
        y = torch.zeros_like(xb)
        for d, off in enumerate(offs):
            y = y + data[d] * xp[..., maxo + off: maxo + off + bs]
        return y

    def single_diag_vector(self, args, n: int) -> torch.Tensor:
        for d, off in enumerate(self.dia_ii.offsets):
            if off == 0:
                return args[d]
        return torch.zeros((n,), dtype=self.dtype, device=self.device)

    def diag_coo_np(self):
        """Per-block COO of ``A_ii`` on the host, in ``single_diag_mv``'s
        row-aligned convention ``A_ii[i, i + off] = args[d, i]``."""
        args = self.diag_mv_args.cpu().numpy()
        bs = self.block_size
        out = []
        for b in range(self.nblocks):
            rows, cols, vals = [], [], []
            for d, off in enumerate(self.dia_ii.offsets):
                i = np.arange(max(0, -off), min(bs, bs - off))
                rows.append(i)
                cols.append(i + off)
                vals.append(args[b, d, i])
            r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
            m = v != 0
            out.append((r[m], c[m], v[m]))
        return out

    def to_dense(self) -> torch.Tensor:
        return self.dia_ii.to_dense() + self.dia_ic.to_dense()


@dataclasses.dataclass(frozen=True)
class StackedBSROperator(_SparseBlockOperator):
    """Blockable general-sparse path (the multisplitting analog of
    ``core.operators.BSR``).

    ``ii_idx`` ``(nb, nbr, w)`` int32 block-local block-column ids and
    ``ii_val`` ``(nb, nbr, w, c, c)`` transposed ``(c, c)`` blocks: each
    ``A_ii`` as block-ELL with a shared width, ``nbr = ceil(bs / c)``.
    ``ii_diag`` ``(nb, bs)``: the diagonal of each ``A_ii`` (Jacobi).
    ``ic``: the coupling as one global ``BSR`` over the merged vector.

    ``diag_mv`` is one launch of kernel I over a block-diagonal pack: block
    ``b``'s block-column ids moved by ``b * nbr`` turn the ``nb`` stacks
    into one ``(nb * nbr, w)`` pack over the merged vector, each block
    padded from ``bs`` to ``nbr * c``.  ``coupling_mv`` is kernel I on
    ``ic``, ``single_diag_mv`` kernel I on one block's pack.  Build with
    ``stacked_bsr_from_ell``."""

    ii_idx: torch.Tensor
    ii_val: torch.Tensor
    ii_diag: torch.Tensor
    ic: BSR
    nblocks: int
    block_size: int
    merged_idx: torch.Tensor = dataclasses.field(init=False, repr=False,
                                                 compare=False)
    inverses: dict = _inverses_field()

    def __post_init__(self):
        _check_dtype("StackedBSROperator", self.ii_val.dtype)
        nb, nbr, w = self.ii_idx.shape
        shift = torch.arange(nb, dtype=torch.int32,
                             device=self.ii_idx.device) * nbr
        object.__setattr__(self, "merged_idx", (
            self.ii_idx + shift[:, None, None]).reshape(nb * nbr, w))

    @property
    def c(self) -> int:
        return self.ii_val.shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nblocks * self.block_size
        return (n, n)

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.ii_val)
                   + torch.count_nonzero(self.ic.values))

    @property
    def dtype(self) -> torch.dtype:
        return self.ii_val.dtype

    @property
    def device(self) -> torch.device:
        return self.ii_val.device

    def diag_mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A_ii x_i`` for every block of ``x`` (``(nb, bs)`` or a panel
        ``(s, nb, bs)``): one launch of kernel I on the block-diagonal
        pack."""
        nb, bs = self.nblocks, self.block_size
        padded = self.ii_idx.shape[1] * self.c
        xp = x if padded == bs else F.pad(x, (0, padded - bs))
        n = nb * padded
        y = bsr_mv(self.merged_idx, self.ii_val.reshape(
            (-1,) + self.ii_val.shape[2:]), _merged(xp), n, n)
        y = y.reshape(x.shape[:-1] + (padded,))
        return y if padded == bs else y[..., :bs].contiguous()

    def coupling_mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.ic.mv(_merged(x)).reshape(x.shape)

    @property
    def diag_mv_args(self):
        return (self.ii_idx, self.ii_val, self.ii_diag)

    def single_diag_mv(self, args, xb: torch.Tensor) -> torch.Tensor:
        """``A_ii x_i`` of one block on ``xb`` ``(bs,)`` or ``(k, bs)``:
        kernel I on that block's ``(nbr, w)`` pack."""
        idx, val, _ = args
        bs = xb.shape[-1]
        return bsr_mv(idx, val, xb, bs, bs)

    def single_diag_vector(self, args, n: int) -> torch.Tensor:
        return args[2]

    def diag_coo_np(self):
        """Per-block COO of ``A_ii`` on the host (the ``pc='bjacobi'``
        set-up hook): blocks un-transposed, entries in (block row, slot,
        row, column) order, the padding past ``block_size`` dropped."""
        idx = self.ii_idx.cpu().numpy()
        c, bs = self.c, self.block_size
        out = []
        for b in range(self.nblocks):
            blk = self.ii_val[b].cpu().numpy().swapaxes(-1, -2)
            r, k, i, j = np.nonzero(blk)
            rows, cols = r * c + i, idx[b][r, k].astype(np.int64) * c + j
            m = (rows < bs) & (cols < bs)
            out.append((rows[m], cols[m], blk[r, k, i, j][m]))
        return out

    def to_dense(self) -> torch.Tensor:
        bs = self.block_size
        dense = self.ic.to_dense()
        for b, (r, cc, v) in enumerate(self.diag_coo_np()):
            sub = torch.zeros((bs, bs), dtype=self.dtype, device=self.device)
            sub[torch.from_numpy(r), torch.from_numpy(cc)] = torch.from_numpy(
                v).to(sub)
            dense[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs] += sub
        return dense


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def from_stacked_ell(op: StackedELLOperator, max_diags: int = 64):
    """A banded ``StackedELLOperator`` as ``StackedDIAOperator``, or ``op``
    itself when either part has more than ``max_diags`` distinct
    diagonals.  Host-side one-time repack (numpy): every nonzero ``A[g,
    c]`` lands on diagonal ``c - g`` of a global row-aligned plane; the
    planes keep the ELL values' dtype and device."""
    nb, bs = op.nblocks, op.block_size
    n = nb * bs

    def planes(ell, local):
        idx, val = _host(ell.indices), _host(ell.values)
        nz = val != 0
        rows_g = np.broadcast_to(np.arange(n).reshape(nb, bs, 1),
                                 idx.shape)[nz]
        cols_g = idx[nz].astype(np.int64)
        if local:
            # A_ii column ids are block-local: globalize by block offset
            cols_g += (rows_g // bs) * bs
        d = cols_g - rows_g
        # the distinct diagonals, counted without a sort
        offs = np.flatnonzero(np.bincount(d + (n - 1),
                                          minlength=2 * n - 1)) - (n - 1)
        if offs.size > max_diags:
            return None
        data = np.zeros((offs.size, n), val.dtype)
        np.add.at(data, (np.searchsorted(offs, d), rows_g), val[nz])
        return DIA(data=torch.from_numpy(data).to(op.device),
                   offsets=tuple(int(o) for o in offs))

    dia_ii = planes(op.a_ii, local=True)
    dia_ic = None if dia_ii is None else planes(op.a_ic, local=False)
    if dia_ic is None:
        return op
    return StackedDIAOperator(dia_ii=dia_ii, dia_ic=dia_ic, nblocks=nb)


def stacked_bsr_from_ell(op: StackedELLOperator,
                         block_sizes: Tuple[int, ...] = (8, 16, 32, 64),
                         max_cost: float = 16.0):
    """A blockable ``StackedELLOperator`` as ``StackedBSROperator``, or None
    when no sub-block size ``c`` of ``block_sizes`` keeps the estimated
    cost per nonzero (the padded fill of the diagonal parts and the
    coupling together, times the calibrated per-stored-value penalty of
    ``c``, ``core.calibration.bsr_bs_penalty``) within ``max_cost``.  The
    cheapest ``c`` is taken; the packs are built on the host."""
    penalty = bsr_bs_penalty()
    nb, bsz = op.nblocks, op.block_size
    n = nb * bsz
    ii_idx, ii_val = _host(op.a_ii.indices), _host(op.a_ii.values)
    ic_idx, ic_val = _host(op.a_ic.indices), _host(op.a_ic.values)
    rows_local = np.broadcast_to(np.arange(bsz)[:, None], ii_idx.shape[1:])
    # each block's A_ii entries (local rows and columns), and the coupling
    # with global rows
    parts = []
    for b in range(nb):
        m = ii_val[b] != 0
        parts.append((rows_local[m], ii_idx[b][m], ii_val[b][m]))
    mic = ic_val != 0
    rows_g = np.broadcast_to(np.arange(n).reshape(nb, bsz, 1), ic_idx.shape)
    rg, cg, vg = rows_g[mic], ic_idx[mic], ic_val[mic]
    total = sum(len(p[0]) for p in parts) + len(rg)

    best = None
    for c in block_sizes:
        stored = sum(bsr_block_fill_from_coo(r, cc, (bsz, bsz), c) * len(r)
                     for r, cc, _ in parts)
        if len(rg):
            stored += bsr_block_fill_from_coo(rg, cg, (n, n), c) * len(rg)
        cost = stored / max(total, 1) * penalty.get(c, 1.0)
        if cost <= max_cost and (best is None or cost < best[1]):
            best = (c, cost)
    if best is None:
        return None
    c = best[0]

    # per-block diagonal packs with a shared width
    packs = [_bsr_pack_np(r, cc, v, (bsz, bsz), c) for r, cc, v in parts]
    w = max(p[0].shape[1] for p in packs)
    nbr = packs[0][0].shape[0]
    idx_all = np.zeros((nb, nbr, w), np.int32)
    val_all = np.zeros((nb, nbr, w, c, c), ii_val.dtype)
    for b, (i_, v_) in enumerate(packs):
        idx_all[b, :, : i_.shape[1]] = i_
        val_all[b, :, : v_.shape[1]] = v_
    del packs

    # the diagonal of each A_ii (Jacobi)
    dvec = np.zeros((nb, bsz))
    for b, (r, cc, v) in enumerate(parts):
        on = r == cc
        np.add.at(dvec[b], r[on], v[on])

    dev, dtype = op.device, op.dtype
    return StackedBSROperator(
        ii_idx=torch.from_numpy(idx_all).to(dev),
        ii_val=torch.from_numpy(val_all).to(device=dev, dtype=dtype),
        ii_diag=torch.from_numpy(dvec).to(device=dev, dtype=dtype),
        ic=BSR.from_coo(rg, cg, vg, (n, n), bs=c, dtype=dtype, device=dev),
        nblocks=nb, block_size=bsz)


def as_stacked_routed_operator(op, max_diags: int = 64,
                               max_bsr_cost: float = 16.0,
                               bsr_block_sizes: Tuple[int, ...] = (8, 16, 32,
                                                                   64)):
    """The representation suited to the card for a stacked operator (the
    blockwise analog of ``core.operators.as_routed_operator``; JAX's
    ``as_stacked_tpu_operator``): a banded ``StackedELLOperator`` becomes
    DIA planes, a blockable one ``StackedBSROperator``, and any other
    stays as it is with a ``UserWarning``.  Other operators pass
    through."""
    if isinstance(op, StackedELLOperator):
        out = from_stacked_ell(op, max_diags=max_diags)
        if out is not op:
            return out
        bsr = stacked_bsr_from_ell(op, bsr_block_sizes, max_bsr_cost)
        if bsr is not None:
            return bsr
        warnings.warn(
            "as_stacked_routed_operator: block split is neither banded "
            f"(> {max_diags} distinct diagonals) nor blockable (estimated "
            f"BSR cost > {max_bsr_cost}x per nonzero); staying on the "
            "stacked ELL operator, whose products run kernel H on the CSR "
            "of its planes", UserWarning, stacklevel=2)
    return op


def block_poisson2d(m: int, n: int, nblocks: int = 2) -> StackedStencil2D:
    return StackedStencil2D(m=m, n=n, nblocks=nblocks)


def block_poisson3d(nx: int, ny: int, nz: int,
                    nblocks: int = 2) -> StackedStencil3D:
    return StackedStencil3D(nx=nx, ny=ny, nz=nz, nblocks=nblocks)


def block_poisson2d_ell(m: int, n: int, nblocks: int = 2,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> StackedELLOperator:
    """The assembled 2D Poisson matrix, block-split into stacked ELL."""
    a_ii, a_ic = poisson.block_split_ell(*poisson.poisson2d_coo(m, n),
                                         nblocks=nblocks, dtype=dtype,
                                         device=device)
    return StackedELLOperator(a_ii=a_ii, a_ic=a_ic)


def rhs_ones(op: BlockOperator, dtype: Optional[torch.dtype] = None,
             device=None) -> torch.Tensor:
    """Stacked ``b = A 1`` (exact solution u = 1), the analog of
    ``computeTheRightHandSideWithInitialGuess`` (``utils.c:623-650``), on
    ``device`` (None: the current CUDA device)."""
    ones = torch.ones((op.nblocks, op.block_size),
                      dtype=op.dtype if dtype is None else dtype,
                      device=resolve(device))
    return op.full_mv(ones)


def final_residual_norm(op: BlockOperator, xs: torch.Tensor,
                        bs: torch.Tensor) -> torch.Tensor:
    """Global true residual norm with per-block full-length iterates
    (``computeFinalResidualNorm_new``, ``utils.c:597-620``): block ``i``
    applies its row strip ``A_i`` to its own merged ``xs[i]`` (shape
    ``(nblocks, nblocks * block_size)``), ``r_i = bs[i] - A_i xs[i]``, and
    the norm is ``sqrt(sum_i ||r_i||^2)``."""
    nb = op.nblocks
    r = torch.stack([bs[i] - op.full_mv(xs[i].reshape(nb, op.block_size))[i]
                     for i in range(nb)])
    return torch.sqrt(torch.sum(r * r))
