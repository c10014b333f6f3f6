"""The matrix-free 2D 5-point and 3D 7-point Poisson operators.

Port of the JAX package's ``core/operators.Stencil2D`` and ``Stencil3D``
with the methods the solvers call, under the same names so that
``solvers/multigrid.py`` and ``solvers/krylov.py`` port line for line.
Every method goes through one kernel of ``ops/stencil2d.py`` or
``ops/stencil3d.py``, at every size and shape: there is no size cutoff or
alignment gate to fall back from on the card.  On the CPU the kernels'
plain versions run instead.

Methods are shape-polymorphic: they take the flat vector or the grid
(``(m, n)``, ``(nx, ny, nz)``) and return the same shape.  Unknown order
is the grid flattened C-style.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops import stencil3d as k
from medane_tchakorom_ufc_thesis_repository_tpu_torch.ops.stencil2d import (
    stencil2d_apply,
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

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """``A x`` (kernel E with batch 1)."""
        y = stencil2d_apply(x.reshape(1, self.m, self.n), diag=self.diag,
                            off=self.off)
        return y.reshape(x.shape)

    rmv = mv  # symmetric

    def to_dense(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.poisson import (
            poisson2d_dense_np,
        )

        return torch.as_tensor(
            poisson2d_dense_np(self.m, self.n, self.diag, self.off),
            dtype=torch.get_default_dtype() if dtype is None else dtype)


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
