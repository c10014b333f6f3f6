"""Block-Jacobi preconditioner with batched dense block inverses (port of
the JAX package's ``solvers/bjacobi.py``).

The ``(bs, bs)`` diagonal blocks are inverted once at set-up, on the host
in f64, and ``z = blkdiag(B_k^{-1}) r`` is applied as one batched matrix
product in full f32: no triangular sweeps, no data-dependent control
flow.  An explicit inverse is accurate enough for a preconditioner; the
cast to the run dtype, not the inversion, bounds its error.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from medane_tchakorom_ufc_thesis_repository_tpu_torch.core.device import resolve
from medane_tchakorom_ufc_thesis_repository_tpu_torch.solvers.lstsq import (
    full_matmul,
)

__all__ = ["BlockJacobi", "block_jacobi_from_coo", "block_jacobi_from_scipy"]


@dataclasses.dataclass(frozen=True)
class BlockJacobi:
    """``M ~= blkdiag(A)^{-1}``.  ``inv_blocks``: ``(nb, bs, bs)`` inverses
    of the diagonal blocks (padded tail rows carry identity); ``n`` is the
    true vector length."""

    inv_blocks: torch.Tensor
    n: int

    @property
    def bs(self) -> int:
        return self.inv_blocks.shape[-1]

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """``z = M r`` for ``r`` of shape ``(n,)`` or ``(k, n)``: pad to a
        block multiple, one batched product, cut."""
        nb, bs, _ = self.inv_blocks.shape
        rb = F.pad(r, (0, nb * bs - self.n)).reshape(r.shape[:-1] + (nb, bs))
        z = full_matmul(self.inv_blocks, rb[..., None])[..., 0]
        return z.reshape(r.shape[:-1] + (-1,))[..., : self.n]

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply(r)

    def to(self, device) -> "BlockJacobi":
        return dataclasses.replace(
            self, inv_blocks=self.inv_blocks.to(resolve(device)))


def block_jacobi_from_coo(rows, cols, vals, n: int, bs: int = 64,
                          dtype: torch.dtype = torch.float32,
                          device=None) -> BlockJacobi:
    """Host-side set-up: take the ``(bs, bs)`` diagonal blocks of an
    ``n x n`` COO matrix, invert them in f64, and put the ``(nb, bs, bs)``
    inverses on ``device`` (None: the current CUDA device).

    Padded tail rows get identity so the last block stays invertible.  A
    singular diagonal block gets its pseudo-inverse."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float64)
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    nb = -(-n // bs)
    mask = (rows // bs) == (cols // bs)
    flat = ((rows[mask] // bs).astype(np.int64) * bs + rows[mask] % bs) * bs \
        + cols[mask] % bs
    blocks = np.bincount(flat, weights=vals[mask],
                         minlength=nb * bs * bs).reshape(nb, bs, bs)
    if nb * bs != n:
        tail = np.arange(n % bs, bs)
        blocks[nb - 1, tail, tail] = 1.0
    try:
        inv = np.linalg.inv(blocks)
        finite = np.isfinite(inv).all()
    except np.linalg.LinAlgError:
        inv, finite = None, False
    if inv is None or not finite:
        inv = np.empty_like(blocks)
        for k in range(nb):
            try:
                inv[k] = np.linalg.inv(blocks[k])
                if not np.isfinite(inv[k]).all():
                    raise np.linalg.LinAlgError
            except np.linalg.LinAlgError:
                inv[k] = np.linalg.pinv(blocks[k])
    return BlockJacobi(
        inv_blocks=torch.from_numpy(inv).to(device=resolve(device),
                                            dtype=dtype), n=int(n))


def block_jacobi_from_scipy(A, bs: int = 64,
                            dtype: torch.dtype = torch.float32,
                            device=None) -> BlockJacobi:
    """``block_jacobi_from_coo`` over a ``scipy.sparse`` matrix."""
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"block Jacobi needs a square matrix, got {A.shape}")
    coo = A.tocoo()
    return block_jacobi_from_coo(coo.row, coo.col, coo.data, A.shape[0],
                                 bs=bs, dtype=dtype, device=device)
