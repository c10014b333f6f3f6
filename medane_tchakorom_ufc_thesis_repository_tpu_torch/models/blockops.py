"""Stacked block operators (port of the JAX package's
``models/blockops.py``, the stencil strips): the Jacobi-block
decomposition as data layout.

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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.operators import (
    Stencil2D,
    Stencil3D,
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
        """Kernel A (kind ``mv``) on each grid of a contiguous stack."""
        return torch.stack([stencil3d_apply(g, kind="mv", diag=self.diag,
                                            off=self.off) for g in grids])

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


def block_poisson2d(m: int, n: int, nblocks: int = 2) -> StackedStencil2D:
    return StackedStencil2D(m=m, n=n, nblocks=nblocks)


def block_poisson3d(nx: int, ny: int, nz: int,
                    nblocks: int = 2) -> StackedStencil3D:
    return StackedStencil3D(nx=nx, ny=ny, nz=nz, nblocks=nblocks)


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
